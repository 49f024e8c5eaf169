"""Write-ahead plan journal: the crash-only half of the executor.

Port of the JAX package's ``scheduler/journal.py``; its records are the JAX
package's (schema ``eeg-tpu-plan-journal/v1``), so either package's
:meth:`PlanJournal.entries` reads the other's directory.

- One JSON file per plan (``plan-<id>.json``) under the journal directory:
  no index to corrupt, and a directory scan is recovery.
- Every write is atomic (a tmp sibling, fsync, ``os.replace``;
  ``io/modelfiles.atomic_write_bytes``) and then the directory is fsynced,
  so a record is the previous one or the new one, never a truncation, and
  the rename itself is on disk before anyone relies on it (a refused
  directory fsync is counted, ``scheduler.journal_dir_fsync_failed``).
- Two durable states: ``submitted``, written before the plan's first
  device work, and a terminal ``completed`` (the statistics text and its
  sha256) or ``failed`` (the error). A crash between them leaves
  ``submitted``, which recovery re-runs from the query alone; the pipeline
  is deterministic, so the re-run's statistics are byte-identical.
  Recovery never touches a terminal record: a completed plan is never
  re-run and never re-recorded.

Every record write passes the ``scheduler.journal`` injection point. A
failing write is retried once, then the plan runs unjournaled: counted
(``scheduler.journal_write_failed``) and logged, never raised. A plan whose
completion write was lost re-runs on recovery; one whose submission write
was lost is invisible to it.

Pod-assist records (``podassist-<id>.json``) are written and read as the
JAX package's are; their consumer, the fleet's pod assist, is not ported.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

SCHEMA = "eeg-tpu-plan-journal/v1"

SUBMITTED = "submitted"
COMPLETED = "completed"
FAILED = "failed"


def _utc() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def _atomic_write_text(path: str, text: str) -> None:
    from ..io import modelfiles

    modelfiles.atomic_write_bytes(path, text.encode("utf-8"))


class PlanJournal:
    """One directory of per-plan journal records."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, plan_id: str) -> str:
        return os.path.join(self.directory, f"plan-{plan_id}.json")

    # -- writes

    def _write(self, plan_id: str, payload: Dict[str, Any]) -> bool:
        """One atomic record write through the chaos point; True when the
        record landed. A journal failure degrades the guarantee, never the
        plan."""
        from .. import obs
        from ..checkpoint import manager
        from ..obs import chaos, events

        text = json.dumps({"schema": SCHEMA, **payload}, indent=2, sort_keys=True) + "\n"
        last_error: Optional[Exception] = None
        for _attempt in (1, 2):
            try:
                chaos.maybe_fire("scheduler.journal")
                _atomic_write_text(self._path(plan_id), text)
                if not manager._fsync_directory(self.directory):
                    obs.metrics.count("scheduler.journal_dir_fsync_failed")
                return True
            except Exception as e:
                last_error = e
        obs.metrics.count("scheduler.journal_write_failed")
        events.event("scheduler.journal_write_failed", plan=plan_id,
                     error=f"{type(last_error).__name__}: {last_error}")
        logger.error(
            "plan journal write failed for %s (%s: %s); continuing unjournaled: a "
            "crash before completion will re-run this plan (or lose its completion "
            "record)", plan_id, type(last_error).__name__, last_error,
        )
        return False

    def record_submitted(self, plan_id: str, query: str,
                         meta: Optional[Dict[str, Any]] = None) -> bool:
        """The write-ahead record: it must land before the plan runs for
        the plan to be recoverable."""
        return self._write(plan_id, {
            "plan_id": plan_id, "state": SUBMITTED, "query": query,
            "submitted_utc": _utc(), "meta": meta or {},
        })

    def record_completed(self, plan_id: str, query: str, statistics_text: str,
                         attempts: int = 1, meta: Optional[Dict[str, Any]] = None) -> bool:
        """The exactly-once completion record."""
        return self._write(plan_id, {
            "plan_id": plan_id, "state": COMPLETED, "query": query,
            "completed_utc": _utc(), "attempts": attempts,
            "statistics": statistics_text,
            "statistics_sha256": hashlib.sha256(statistics_text.encode()).hexdigest(),
            "meta": meta or {},
        })

    def record_failed(self, plan_id: str, query: str, error: str, attempts: int = 1,
                      meta: Optional[Dict[str, Any]] = None) -> bool:
        """Terminal failure (retry budget or deadline spent, a caller
        error, a shed, a cancel): recovery does not re-run it. ``meta``
        carries the idempotency key, so a keyed re-submit replays the
        outcome (a shed omits it: backpressure stays retryable)."""
        return self._write(plan_id, {
            "plan_id": plan_id, "state": FAILED, "query": query,
            "failed_utc": _utc(), "attempts": attempts, "error": error,
            "meta": meta or {},
        })

    # -- pod-assist records

    ASSIST_SCHEMA = "eeg-tpu-pod-assist/v1"

    def _assist_path(self, plan_id: str) -> str:
        return os.path.join(self.directory, f"podassist-{plan_id}.json")

    def record_assist(self, plan_id: str, coordinator: str, processes: int, holder: str,
                      pid: int, start_token: str, query: str) -> bool:
        """Publish a pod-assist request (the coordinator of a
        ``processes=N`` plan asks peers for N-1 worker processes); the
        ``podassist-`` prefix keeps it out of :meth:`entries`."""
        payload = {
            "schema": self.ASSIST_SCHEMA, "plan_id": plan_id, "coordinator": coordinator,
            "processes": int(processes), "holder": holder, "pid": int(pid),
            "start_token": start_token, "query": query, "since": time.time(),
        }
        try:
            _atomic_write_text(self._assist_path(plan_id),
                               json.dumps(payload, indent=2, sort_keys=True) + "\n")
            return True
        except Exception as e:
            logger.warning("pod-assist record write failed for %s (%s: %s)",
                           plan_id, type(e).__name__, e)
            return False

    def assist_entries(self) -> List[Dict[str, Any]]:
        """Every readable pod-assist request, oldest first (an unreadable
        one is skipped: the records are advisory)."""
        try:
            names = sorted(os.listdir(self.directory))
        except FileNotFoundError:
            return []
        out: List[Dict[str, Any]] = []
        for name in names:
            if not (name.startswith("podassist-") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.directory, name)) as f:
                    rec = json.load(f)
                rec["plan_id"]  # noqa: B018 - the shape check
            except Exception:
                continue
            out.append(rec)
        out.sort(key=lambda r: r.get("since", 0.0))
        return out

    def clear_assist(self, plan_id: str) -> None:
        try:
            os.unlink(self._assist_path(plan_id))
        except OSError:
            pass

    # -- reads

    def _quarantine(self, path: str, error: Exception) -> None:
        """Move an unparseable record aside as ``<name>.corrupt`` and count
        it (``scheduler.journal_corrupt``): one bad file must never wedge a
        scan, and the bytes are kept for diagnosis."""
        from .. import obs
        from ..obs import events

        obs.metrics.count("scheduler.journal_corrupt")
        events.event("scheduler.journal_corrupt", path=path,
                     error=f"{type(error).__name__}: {error}")
        try:
            os.replace(path, path + ".corrupt")
            logger.error("quarantined corrupt journal record %s -> %s.corrupt (%s: %s)",
                         path, path, type(error).__name__, error)
        except OSError as move_error:
            logger.error("corrupt journal record %s (%s: %s) could not be quarantined "
                         "(%s); skipping it", path, type(error).__name__, error, move_error)

    def entries(self) -> List[Dict[str, Any]]:
        """Every readable record, in plan-id order, numerically past 9,999
        (``plan-p10000`` after ``plan-p9999``). An unparseable file is
        quarantined, never a crash."""
        def order(name: str):
            stem = name[len("plan-"):-len(".json")]
            if stem.startswith("p") and stem[1:].isdigit():
                return (0, int(stem[1:]), name)
            return (1, 0, name)

        try:
            names = sorted((n for n in os.listdir(self.directory)
                            if n.startswith("plan-") and n.endswith(".json")), key=order)
        except OSError:
            return []
        out = []
        for name in names:
            path = os.path.join(self.directory, name)
            try:
                with open(path) as f:
                    out.append(json.load(f))
            except ValueError as e:
                self._quarantine(path, e)
            except OSError as e:
                logger.warning("skipping unreadable journal record %s (%s: %s)",
                               path, type(e).__name__, e)
        return out

    def unfinished(self) -> List[Dict[str, Any]]:
        """The records recovery re-runs: submitted, never terminal."""
        return [e for e in self.entries() if e.get("state") == SUBMITTED]

    def entry(self, plan_id: str) -> Optional[Dict[str, Any]]:
        try:
            with open(self._path(plan_id)) as f:
                return json.load(f)
        except ValueError as e:
            self._quarantine(self._path(plan_id), e)
            return None
        except OSError:
            return None
