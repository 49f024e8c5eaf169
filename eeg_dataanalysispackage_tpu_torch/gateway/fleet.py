"""The replicated gateway fleet: N front doors over one shared journal.

Port of the JAX package's ``gateway/fleet.py``. The write-ahead journal (one
atomic file a plan) is the source of truth, and recovery and idempotent
replay exist in every process; what a fleet adds is who executes a record,
and that is ``scheduler/lease.py``'s ``plan-<id>.lease`` file.

One :class:`FleetReplica` wraps one :class:`~.server.GatewayServer` over the
shared ``journal_dir``:

- **accept anywhere**: a submission to any replica lease-claims its plan
  before the write-ahead record lands (``scheduler/executor.py``), so a peer
  scanning the journal never sees an unleased record a live replica owns;
- **finish anywhere**: the scan loop polls ``PlanJournal.unfinished()`` for
  submitted records nobody live holds and claims them through
  ``PlanExecutor.claim_and_run``; the record's query re-parses and the
  completion lands under the original plan id, so a killed replica's plans
  complete on a survivor with the same statistics;
- **leave gracefully**: :meth:`FleetReplica.drain` (the SIGTERM path of
  ``python -m eeg_dataanalysispackage_tpu_torch.gateway``) answers 503 and
  not-ready, releases every queued plan's lease so peers take over at once,
  finishes what runs, then stops.

The scan loop is also recovery: a replica starting over a journal with
unfinished records claims them as it claims a dead peer's, so the replica's
gateway runs without the single-process ``recover()``. The replica
registers its lease directory (``lease.set_active``, which a crash report's
``held_leases`` reads), heartbeats its leases, and attaches the device pool
``EEG_TPU_DEVICE_POOL`` asks for (``scheduler/placement.py``) and a
:class:`PodAssist` to its executor.

Replicas share one journal directory (one filesystem), and a holder's death
is checked by pid and start token: a same-host or shared-mount fleet, not a
consensus protocol.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .. import obs
from ..scheduler import lease as lease_mod
from ..scheduler import placement as placement_mod
from .server import GatewayServer

logger = logging.getLogger(__name__)

#: how often a replica scans the shared journal for claimable records
ENV_SCAN_INTERVAL = "EEG_TPU_FLEET_SCAN_INTERVAL_S"
_DEFAULT_SCAN_INTERVAL_S = 0.25

#: "0" turns the per-replica scan jitter off (lockstep scans)
ENV_SCAN_JITTER = "EEG_TPU_FLEET_SCAN_JITTER"

#: jitter amplitude as a fraction of the scan interval
_SCAN_JITTER_AMPLITUDE = 0.25

#: seconds a pod-assist member may run before it is killed
ENV_ASSIST_MAX = "EEG_TPU_ASSIST_MAX_S"
#: worker ranks one replica parents at once
ENV_ASSIST_WORKERS = "EEG_TPU_ASSIST_WORKERS"


def scan_interval() -> float:
    value = os.environ.get(ENV_SCAN_INTERVAL)
    if not value:
        return _DEFAULT_SCAN_INTERVAL_S
    try:
        return float(value)
    except ValueError:
        logger.warning("unparseable %s=%r; using the default %.2fs",
                       ENV_SCAN_INTERVAL, value, _DEFAULT_SCAN_INTERVAL_S)
        return _DEFAULT_SCAN_INTERVAL_S


def jittered_scan_interval(replica_id: str, base: Optional[float] = None) -> float:
    """The replica's scan interval: the base ±25%, offset by a
    deterministic function of the replica id (blake2b), so N replicas do
    not race every record in lockstep and a replica's cadence is stable
    across restarts. ``EEG_TPU_FLEET_SCAN_JITTER=0`` turns it off."""
    if base is None:
        base = scan_interval()
    if os.environ.get(ENV_SCAN_JITTER, "").strip() == "0":
        return base
    digest = hashlib.blake2b(replica_id.encode(), digest_size=8).digest()
    unit = int.from_bytes(digest, "big") / float(2 ** 64)  # [0, 1)
    factor = 1.0 + _SCAN_JITTER_AMPLITUDE * (2.0 * unit - 1.0)
    return max(0.001, base * factor)


class FleetReplica:
    """One gateway replica of a shared-journal fleet.

    Pass an existing server, or let the replica build one from the keyword
    knobs (``device=`` among them: ``None`` is ``cuda``, which raises
    without a card). The server's executor needs a ``journal_dir``.
    ``start()`` starts the HTTP front door without ``recover()`` and the
    scan and heartbeat threads."""

    def __init__(self, server: Optional[GatewayServer] = None,
                 replica_id: Optional[str] = None, scan_interval_s: Optional[float] = None,
                 heartbeat_interval_s: Optional[float] = None, **gateway_kwargs: Any):
        if server is None:
            gateway_kwargs.setdefault("recover", False)
            server = GatewayServer(replica_id=replica_id, **gateway_kwargs)
        self.server = server
        self.executor = server.executor
        if self.executor.journal is None:
            raise ValueError("a fleet replica needs a journal_dir — the shared journal "
                             "directory IS the fleet")
        if replica_id:
            server.replica_id = replica_id
        self.replica_id = server.replica_id
        # fleet-scope recovery is the scan loop: one takeover path
        server._recover = False
        self.leases = lease_mod.LeaseDir(self.executor.journal.directory,
                                         holder=self.replica_id)
        self.executor.leases = self.leases
        lease_mod.set_active(self.leases)
        self._scan_interval_s = jittered_scan_interval(self.replica_id, base=scan_interval_s)
        # the shared device pool: None unless EEG_TPU_DEVICE_POOL turns it on
        self.pool = placement_mod.DevicePool.from_env(self.leases)
        self.executor.placement = self.pool
        self.pod_assist = PodAssist(self)
        self.executor.pod_assist = self.pod_assist
        self._heartbeat_interval_s = (
            heartbeat_interval_s if heartbeat_interval_s is not None
            else min(2.0, max(0.05, lease_mod.lease_timeout() / 4.0)))
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._started = False
        #: plan ids this replica claimed from the scan loop
        self.claimed: List[str] = []
        self._claimed_lock = threading.Lock()

    # -- lifecycle

    def start(self):
        """Start the gateway and the fleet threads; returns (host, port)."""
        if self._started:
            return self.server.host, self.server.port
        self._started = True
        addr = self.server.start()
        for name, target in (("scan", self._scan_loop), ("heartbeat", self._heartbeat_loop)):
            t = threading.Thread(target=target, name=f"eeg-tpu-fleet-{name}-{self.replica_id}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        logger.info("fleet replica %s serving on %s:%d over journal %s", self.replica_id,
                    addr[0], addr[1], self.executor.journal.directory)
        return addr

    def close(self, join_timeout_s: float = 10.0) -> None:
        """Hard stop: the fleet threads, the gateway, our leases. Queued
        journaled plans stay ``submitted`` for peers."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=join_timeout_s)
        self._threads = []
        self.server.close(join_timeout_s=join_timeout_s)
        self.pod_assist.close()
        if self.pool is not None:
            self.pool.release_all()
        self.leases.release_all()

    def drain(self, timeout_s: float = 60.0, poll_s: float = 0.05) -> Dict[str, Any]:
        """Graceful drain: stop accepting (503, not ready), release every
        queued plan's lease for peers, finish what runs, stop. Returns
        ``{released, finished, abandoned}``; ``abandoned`` lists plans still
        running when ``timeout_s`` ran out (their records stay
        ``submitted``, and a peer breaks our stale lease once we exit)."""
        self.server.draining = True
        obs.metrics.count("fleet.drains")
        released = self.executor.drain_queued()
        # what is ours to finish now (a finished ticket leaves live_ids, and
        # status() then reads the journal)
        tracked = list(self.executor.live_ids())
        deadline = time.monotonic() + timeout_s
        while True:
            states = {plan_id: (self.executor.status(plan_id) or {}).get("state")
                      for plan_id in tracked}
            running = [p for p, state in states.items() if state in ("queued", "running")]
            finished = sorted(p for p, state in states.items()
                              if state in ("completed", "failed", "cancelled"))
            if not running or time.monotonic() >= deadline:
                break
            time.sleep(poll_s)
        if running:
            logger.warning("drain timeout with %d plans still running: %s (their journal "
                           "records stay 'submitted')", len(running), running)
        self.close()
        return {"released": released, "finished": finished, "abandoned": running}

    def __enter__(self) -> "FleetReplica":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the scan loop (takeover and fleet-scope recovery)

    def scan_once(self) -> List[str]:
        """One pass over the shared journal: claim every unfinished record
        nobody live holds. Returns the plan ids claimed."""
        claimed: List[str] = []
        for entry in self.executor.journal.unfinished():
            if self._stop.is_set() or self.server.draining:
                break
            plan_id = entry.get("plan_id")
            if not plan_id:
                continue
            try:
                handle = self.executor.claim_and_run(entry)
            except Exception as e:
                # one bad record must not wedge the scan
                logger.error("fleet claim of %s failed (%s: %s); will rescan",
                             plan_id, type(e).__name__, e)
                continue
            if handle is not None:
                claimed.append(plan_id)
                logger.info("replica %s claimed %s (takeover)", self.replica_id, plan_id)
        if claimed:
            with self._claimed_lock:
                self.claimed.extend(claimed)
        return claimed

    def _scan_loop(self) -> None:
        while not self._stop.wait(self._scan_interval_s):
            if self.server.draining:
                continue
            for what, step in (("fleet scan", self.scan_once),
                               ("pod-assist scan", self.pod_assist.scan_assists)):
                try:
                    step()
                except Exception as e:
                    logger.error("%s pass failed (%s: %s); continuing",
                                 what, type(e).__name__, e)

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self._heartbeat_interval_s):
            try:
                self.leases.heartbeat_all()
            except Exception as e:
                logger.error("fleet heartbeat pass failed (%s: %s); continuing",
                             type(e).__name__, e)

    def fleet_view(self) -> Dict[str, Any]:
        """The replica's own fleet snapshot."""
        with self._claimed_lock:
            claimed = list(self.claimed)
        view = {
            "replica": self.replica_id,
            "draining": self.server.draining,
            "journal_dir": self.executor.journal.directory,
            "held": [lease.plan_id for lease in self.leases.held_plan_leases()],
            "claimed": claimed,
            "leases": self.leases.scan(),
            "counters": lease_mod.stats(),
            "devices_held": self.leases.held_device_ordinals(),
            "scan_interval_s": round(self._scan_interval_s, 4),
        }
        if self.pool is not None:
            view["device_pool"] = self.pool.health()
        return view


class PodAssist:
    """The fleet's pod routing, both halves.

    **Coordinator half** (:meth:`run`, from the executor's worker thread for
    a won ``processes=N`` plan): journal a ``podassist-<plan>.json`` record,
    spawn this replica's own rank-0 member as a fresh
    ``parallel.pod_worker`` subprocess on the executor's device
    (``parallel/pod.spawn_pod_member``, ``--device=``), reap it and return
    its statistics text. Every failure returns None, and the executor then
    runs the plan inline, where a pod that cannot assemble raises
    ``PodBootstrapError`` (the JAX package degrades to one host there): the
    plan ends ``failed``, never wedged.

    **Peer half** (:meth:`scan_assists`, from the scan loop): for each live
    assist record of another replica, claim the ``assist:<plan>:<k>`` rank
    leases (one parent a rank, fleet-wide) and spawn worker members. A child
    exits when its parent dies (the pod worker's watchdog) and is killed
    past ``EEG_TPU_ASSIST_MAX_S`` (default 600); ``EEG_TPU_ASSIST_WORKERS``
    (default 2) bounds the ranks one replica parents."""

    def __init__(self, replica: FleetReplica):
        self.replica = replica
        self.journal = replica.executor.journal
        self.leases = replica.leases
        self.device = str(replica.executor.device)
        self._lock = threading.Lock()
        #: lease name -> (Popen, lease, spawn time)
        self._children: Dict[str, Any] = {}
        self.max_child_age_s = float(os.environ.get(ENV_ASSIST_MAX) or 600.0)
        self.worker_cap = int(os.environ.get(ENV_ASSIST_WORKERS) or 2)

    def _spawn(self, query, coordinator, processes, rank):
        from ..parallel import pod as pod_mod

        return pod_mod.spawn_pod_member(query, coordinator, processes, process_id=rank,
                                        device=self.device)

    # -- coordinator half

    def run(self, ticket) -> Optional[str]:
        plan = ticket.plan
        processes = int(plan.pod.processes)
        coordinator = plan.pod.coordinator
        if coordinator is None:
            from ..parallel import distributed

            coordinator = f"127.0.0.1:{distributed.free_port_pair()}"
        obs.metrics.count("fleet.pod_assist_requests")
        self.journal.record_assist(
            ticket.plan_id, coordinator, processes, holder=self.replica.replica_id,
            pid=os.getpid(), start_token=lease_mod._pid_start_token(os.getpid()) or "",
            query=plan.query)
        child = None
        try:
            child = self._spawn(plan.query, coordinator, processes, 0)
            out, err = child.communicate(timeout=self.max_child_age_s)
        except Exception as e:
            logger.warning("pod-assist coordinator member for %s failed (%s: %s); the plan "
                           "runs inline", ticket.plan_id, type(e).__name__, e)
            if child is not None and child.poll() is None:
                child.kill()
                child.communicate()
            obs.metrics.count("fleet.pod_assist_degraded")
            return None
        finally:
            self.journal.clear_assist(ticket.plan_id)
        try:
            if child.returncode != 0:
                raise RuntimeError(f"rc {child.returncode}: {err[-1500:]}")
            statistics = json.loads(out.strip().splitlines()[-1])["statistics"]
        except Exception as e:
            logger.warning("pod-assist coordinator member for %s gave no result (%s); the "
                           "plan runs inline", ticket.plan_id, e)
            obs.metrics.count("fleet.pod_assist_degraded")
            return None
        obs.metrics.count("fleet.pod_assist_completed")
        return statistics

    # -- peer half

    def scan_assists(self) -> List[str]:
        """One pass: reap finished worker children, clear dead coordinators'
        records, claim and spawn ranks for live ones. Returns the lease
        names spawned."""
        self._reap()
        spawned: List[str] = []
        for rec in self.journal.assist_entries():
            plan_id = rec.get("plan_id")
            if not plan_id or rec.get("holder") == self.replica.replica_id:
                continue  # our own request: rank 0 is our child
            if lease_mod._holder_dead(rec.get("pid"), rec.get("start_token") or ""):
                # a killed coordinator's record must not outlive it
                self.journal.clear_assist(plan_id)
                obs.metrics.count("fleet.pod_assist_cleared")
                continue
            try:
                processes = int(rec["processes"])
                coordinator = rec["coordinator"]
                query = rec["query"]
            except (KeyError, TypeError, ValueError):
                continue
            for rank in range(1, processes):
                name = f"assist:{plan_id}:{rank}"
                with self._lock:
                    if len(self._children) >= self.worker_cap:
                        return spawned
                    if name in self._children:
                        continue
                lease = self.leases.try_claim(name)
                if not isinstance(lease, lease_mod.PlanLease):
                    continue
                try:
                    child = self._spawn(query, coordinator, processes, rank)
                except Exception as e:
                    logger.warning("pod-assist worker spawn for %s failed (%s: %s)",
                                   name, type(e).__name__, e)
                    self.leases.release(name)
                    continue
                with self._lock:
                    self._children[name] = (child, lease, time.monotonic())
                obs.metrics.count("fleet.pod_assist_workers")
                spawned.append(name)
        return spawned

    def _reap(self) -> None:
        with self._lock:
            items = list(self._children.items())
        for name, (child, lease, since) in items:
            if child.poll() is None:
                if time.monotonic() - since <= self.max_child_age_s:
                    continue
                # a rank stuck past the budget: kill it, strand nothing
                child.kill()
            child.communicate()
            lease.release()
            with self._lock:
                self._children.pop(name, None)

    def close(self) -> None:
        with self._lock:
            items = list(self._children.items())
            self._children = {}
        for _name, (child, lease, _since) in items:
            if child.poll() is None:
                child.kill()
            child.communicate()
            lease.release()
