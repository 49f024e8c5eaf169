"""The resident multi-plan :class:`PlanExecutor`.

Port of the JAX package's ``scheduler/executor.py``: one process, N plans in
flight on one device, each in its own fault domain (``scheduler/runtime.py``),
sharing the process's feature and plan caches, behind a write-ahead journal
(``scheduler/journal.py``) that makes the executor crash-only.

- **Admission** reuses the serving layer's bounded
  :class:`~..serve.batcher.AdmissionQueue` and resolve-once
  :class:`~..serve.batcher.ServeFuture`: a submission past ``queue_depth``
  sheds with :class:`PlanShedError` carrying the queue's evidence (its
  depth and the oldest queued plan's age) and a terminal journal record.
  A query that does not parse raises at :meth:`PlanExecutor.submit`,
  before anything is journaled or queued.
- **Workers**: ``max_concurrent`` threads, each running one plan at a time
  through ``PipelineBuilder(plan.query, device=self.device)``.
- **Budgets**: ``submit(deadline_s=)`` threads an
  :class:`~..io.deadline.Deadline` through the run (``deadline_scope``),
  and a plan whose budget died in the queue fails at once; a failed
  attempt re-runs up to ``max_attempts`` with backoff, under the one fault
  plan its submission resolved (a ``once@N`` fault absorbed by attempt 1
  stays absorbed). A ``ValueError`` (a caller error) fails at once.
- **Idempotency**: a key journaled with the plan makes a re-submit return
  the original plan's handle: the live one while it runs, the journaled
  outcome once it is terminal, a re-admission of a record a dead process
  left. A shed or a cancel does not bind the key.
- **Cancel-if-queued**, :meth:`~PlanExecutor.recover` (re-admit every
  unfinished record under its original id; completed records are never
  re-run), :meth:`~PlanExecutor.claim_and_run` (with a
  :class:`~.lease.LeaseDir` attached: lease-claim an orphaned record and
  run it exactly once), :meth:`~PlanExecutor.drain_queued` (hand queued
  plans back, their records still ``submitted``) and
  :meth:`~PlanExecutor.close`.

- **Gang scheduling** (``placement``, a ``scheduler/placement.DevicePool``
  the fleet attaches): a popped plan's footprint is lease-claimed
  all-or-nothing before it runs; a footprint that cannot be met now goes
  back to the queue's tail (its journal record stays ``submitted``) so
  smaller plans backfill past it, bounded by the pool's age-based
  promotion. The grant's ordinals reach ``runtime.execute_plan(placement=)``
  and the plan's fleet attribution, and the grant is released when the
  plan's execution ends. A placement attempt that raises runs the plan
  unplaced, counted in ``placement.errors``.
- **Pod assist** (``pod_assist``, ``gateway/fleet.PodAssist``): a
  ``processes=N`` plan without a ``process_id`` runs through it; when it
  returns None the plan runs inline, where a pod that cannot assemble
  raises ``PodBootstrapError`` (the JAX package degrades to one host) and
  the plan ends ``failed`` after its attempts.

The executor runs on ``device`` (``None``: ``cuda``, which raises without a
card). Its plans' kernels go on the device's current stream, and the
builder's stage syncs are device-wide, so a plan's ``featurize`` time may
include a neighbour's kernels; the bits do not change.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Any, Dict, List, Optional

from .. import obs
from ..io import deadline as deadline_mod
from ..obs import chaos, domain as run_domain, events
from ..serve.batcher import AdmissionQueue, ServeFuture, ServiceClosedError, ShedError
from ..utils.device import resolve_device
from . import journal as journal_mod
from . import lease as lease_mod
from . import runtime

logger = logging.getLogger(__name__)

#: :meth:`PlanExecutor._try_place`'s answer when the plan's footprint
#: cannot be met now: the worker readmits it to the queue's tail (distinct
#: from None, "run unplaced")
_PLACEMENT_WAIT = object()


class PlanShedError(ShedError):
    """Admission control refused the plan (queue full). The message carries
    the shed evidence and ``plan_id`` names the journal record the shed
    wrote, so a caller retrying after backpressure can resubmit under it."""

    def __init__(self, message: str, plan_id: Optional[str] = None):
        super().__init__(message)
        self.plan_id = plan_id


class PlanFailedError(RuntimeError):
    """The plan exhausted its retry budget; the message carries the
    per-attempt history."""


class PlanCancelledError(RuntimeError):
    """The plan was cancelled while still queued; it never ran."""


class PlanOwnedElsewhereError(RuntimeError):
    """A live lease holder owns this plan: running it here would run it
    twice. ``holder`` names the owner."""

    def __init__(self, message: str, plan_id: str, holder: Optional[str]):
        super().__init__(message)
        self.plan_id = plan_id
        self.holder = holder


class IdempotencyConflictError(ValueError):
    """An idempotency key was reused with a different query."""


class PlanResult:
    """A completed plan, with its provenance."""

    __slots__ = ("plan_id", "statistics", "builder", "attempts", "report_dir",
                 "recovered", "replayed")

    def __init__(self, plan_id, statistics, builder, attempts, report_dir,
                 recovered=False, replayed=False):
        self.plan_id = plan_id
        self.statistics = statistics
        #: the PipelineBuilder that ran the plan: its per-run attributes
        #: (timers, run_metrics, telemetry, the resolved blocks) are the
        #: plan's own. None for a result replayed from the journal, whose
        #: ``statistics`` is the journaled text
        self.builder = builder
        self.attempts = attempts
        self.report_dir = report_dir
        #: the plan was re-run by journal recovery (or a lease takeover)
        self.recovered = recovered
        #: the result is a terminal journal record's, nothing re-run
        self.replayed = replayed

    def __repr__(self) -> str:
        return (f"PlanResult({self.plan_id}, attempts={self.attempts}, "
                f"recovered={self.recovered}, replayed={self.replayed})")


class _PlanTicket:
    """One admitted plan riding the admission queue."""

    __slots__ = ("plan", "plan_id", "deadline", "future", "submitted_at", "attempts",
                 "history", "fault_plan", "report_dir", "recovered", "state",
                 "idempotency_key", "gateway", "fleet", "trace_id", "tenant", "footprint")

    def __init__(self, plan, plan_id, deadline, fault_plan, report_dir, recovered=False,
                 idempotency_key=None, gateway=None, fleet=None, trace_id=None):
        self.plan = plan
        self.plan_id = plan_id
        self.deadline: Optional[deadline_mod.Deadline] = deadline
        self.future = ServeFuture()
        self.submitted_at = time.monotonic()
        self.attempts = 0
        self.history: List[str] = []
        self.fault_plan = fault_plan
        self.report_dir = report_dir
        self.recovered = recovered
        #: queued -> running -> completed | failed | cancelled
        self.state = "queued"
        self.idempotency_key = idempotency_key
        self.gateway = gateway
        self.fleet = fleet
        self.trace_id = trace_id
        #: the admission queue's per-tenant quota does not apply to plans
        self.tenant = None
        #: ``plan.device_footprint()``, computed at the first placement try
        self.footprint = None

    def batch_key(self):
        return self.plan_id  # plans never coalesce


class _ReplayTicket:
    """A terminal journal record wearing the ticket interface: what a keyed
    re-submit of a finished plan gets back (nothing re-run)."""

    __slots__ = ("plan_id", "query", "future", "state", "attempts", "history",
                 "recovered", "idempotency_key", "gateway")

    def __init__(self, entry: Dict[str, Any]):
        meta = entry.get("meta") or {}
        self.plan_id = entry["plan_id"]
        self.query = entry.get("query", "")
        self.future = ServeFuture()
        self.attempts = int(entry.get("attempts", 1) or 0)
        self.history: List[str] = []
        self.recovered = bool(meta.get("recovered"))
        self.idempotency_key = meta.get("idempotency_key")
        self.gateway = meta.get("gateway")
        if entry.get("state") == journal_mod.COMPLETED:
            self.state = "completed"
            self.future.resolve(PlanResult(
                plan_id=self.plan_id, statistics=entry.get("statistics", ""), builder=None,
                attempts=self.attempts, report_dir=meta.get("report_dir"),
                recovered=self.recovered, replayed=True,
            ))
        else:
            self.state = "failed"
            self.future.fail(PlanFailedError(
                f"plan {self.plan_id} failed (journaled outcome, not re-executed): "
                f"{entry.get('error', '')}"
            ))


class PlanHandle:
    """The submitter's side of one plan: a resolve-once future."""

    __slots__ = ("plan_id", "query", "_ticket", "replayed")

    def __init__(self, ticket, replayed: bool = False):
        self.plan_id = ticket.plan_id
        self.query = ticket.query if isinstance(ticket, _ReplayTicket) else ticket.plan.query
        self._ticket = ticket
        #: the handle resolves an earlier submission's outcome
        self.replayed = replayed

    @property
    def done(self) -> bool:
        return self._ticket.future.done

    @property
    def state(self) -> str:
        """queued | running | completed | failed | cancelled."""
        return self._ticket.state

    @property
    def attempts(self) -> int:
        return self._ticket.attempts

    @property
    def history(self) -> List[str]:
        return list(self._ticket.history)

    def result(self, timeout: Optional[float] = None) -> PlanResult:
        """Block for the outcome; raises the plan's failure
        (PlanFailedError, DeadlineExceededError, or the run's own error)."""
        return self._ticket.future.result(timeout)


class PlanExecutor:
    """N worker threads draining a bounded admission queue of plans on one
    device. ``max_concurrent`` bounds the plans in flight, ``queue_depth``
    the backlog past which submissions shed."""

    def __init__(
        self,
        max_concurrent: int = 2,
        queue_depth: int = 16,
        journal_dir: Optional[str] = None,
        report_root: Optional[str] = None,
        max_attempts: int = 3,
        retry_backoff_s: float = 0.05,
        name: str = "plans",
        device=None,
    ):
        if max_concurrent < 1:
            raise ValueError(f"max_concurrent must be >= 1, got {max_concurrent}")
        #: every plan runs on this device (None: cuda, raising without a card)
        self.device = resolve_device(device)
        self.max_concurrent = int(max_concurrent)
        self.queue = AdmissionQueue(queue_depth)
        self.journal = journal_mod.PlanJournal(journal_dir) if journal_dir else None
        #: a :class:`~.lease.LeaseDir` over the journal directory, attached
        #: before any submission: every admitted plan is then lease-claimed
        #: before its write-ahead record lands and released when its
        #: terminal record lands. None: no leases
        self.leases: Optional[lease_mod.LeaseDir] = None
        #: the fleet's shared device pool (``scheduler/placement.DevicePool``,
        #: attached by ``gateway/fleet.py`` when ``EEG_TPU_DEVICE_POOL`` turns
        #: placement on); None: unplaced execution
        self.placement = None
        #: the fleet's pod-assist runner (``gateway/fleet.PodAssist``); None:
        #: pod plans run in-process through the builder's own bootstrap
        self.pod_assist = None
        #: seconds a worker pauses after parking an unplaceable plan back on
        #: the queue
        self.placement_backoff_s = 0.02
        #: set by :meth:`drain_queued`: a worker holding a placement-waiting
        #: ticket hands it back instead of requeueing it
        self._drain_requested = False
        self.report_root = report_root
        self.max_attempts = int(max_attempts)
        self.retry_backoff_s = float(retry_backoff_s)
        self.name = name
        # ids start past every journaled one: a new executor over a dead
        # process's journal must never overwrite its records
        self._ids = itertools.count(self._seed_id() + 1)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._started = False
        self._lock = threading.Lock()
        self._submit_lock = threading.Lock()
        #: every live ticket by plan id (status, cancel, keyed rejoin); a
        #: ticket is evicted once its terminal record has landed, so memory
        #: is bounded by the queue, not the history
        self._tickets: Dict[str, Any] = {}
        #: idempotency key -> plan id, seeded from the journal
        self._idempotency: Dict[str, str] = self._seed_idempotency()

    def _seed_id(self) -> int:
        if self.journal is None:
            return 0
        max_seen = 0
        for entry in self.journal.entries():
            pid = str(entry.get("plan_id", ""))
            if pid.startswith("p"):
                try:
                    max_seen = max(max_seen, int(pid[1:]))
                except ValueError:
                    pass
        return max_seen

    def _seed_idempotency(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        if self.journal is None:
            return out
        for entry in self.journal.entries():
            key = (entry.get("meta") or {}).get("idempotency_key")
            if key:
                out[str(key)] = entry["plan_id"]
        return out

    # -- lifecycle

    def start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
            for i in range(self.max_concurrent):
                t = threading.Thread(target=self._worker, daemon=True,
                                     name=f"eeg-tpu-{self.name}-worker-{i}")
                t.start()
                self._threads.append(t)

    def close(self, join_timeout_s: float = 10.0) -> None:
        """Stop the workers after the plan each already popped. Queued
        plans stay journaled as submitted (recovery's job) and their
        handles fail with ``ServiceClosedError``."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=join_timeout_s)
        with self._submit_lock:
            pending = self.queue.drain_pending()
        for ticket in pending:
            ticket.state = "failed"
            # releasing the lease lets a peer claim the record now
            self._release_lease(ticket.plan_id)
            ticket.future.fail(ServiceClosedError(
                f"plan {ticket.plan_id} abandoned by executor close()"
                + ("; its journal record stays 'submitted' — a new executor's "
                   "recover() will resume it" if self.journal is not None
                   else "; unjournaled, the plan is lost")
            ))

    def __enter__(self) -> "PlanExecutor":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- submission

    #: how long a keyed submit waits for a peer holding the key's
    #: registration claim to journal its binding before minting anyway
    key_claim_wait_s = 1.0

    def _next_id(self) -> str:
        return f"p{next(self._ids):04d}"

    def _resolve_fleet_key(self, idempotency_key: str):
        """Resolve a previously unseen key across executors sharing the
        journal: re-seed the key index from it and serialize registration
        through a key-scoped lease. ``(plan_id, None)``: the key is bound;
        ``(None, lease)``: this executor registers it and releases the
        lease once its write-ahead record lands; ``(None, None)``:
        claiming unavailable or a peer held the claim past
        :attr:`key_claim_wait_s` (``scheduler.key_claim_degraded``)."""
        claim_id = lease_mod.key_claim_id(idempotency_key)

        def reseed() -> Optional[str]:
            for k, v in self._seed_idempotency().items():
                self._idempotency.setdefault(k, v)
            return self._idempotency.get(idempotency_key)

        deadline = time.monotonic() + self.key_claim_wait_s
        while True:
            claim = self.leases.try_claim(claim_id)
            if isinstance(claim, lease_mod.PlanLease):
                existing = reseed()
                if existing is not None:
                    self.leases.release(claim_id)
                    return existing, None
                return None, claim
            existing = reseed()
            if existing is not None:
                return existing, None
            if claim is None:
                obs.metrics.count("scheduler.key_claim_degraded")
                return None, None
            if time.monotonic() >= deadline:
                obs.metrics.count("scheduler.key_claim_degraded")
                logger.warning("idempotency key %r: registration claim held elsewhere past "
                               "%.1fs without a journaled binding; proceeding best-effort",
                               idempotency_key, self.key_claim_wait_s)
                return None, None
            time.sleep(0.02)

    def submit(
        self,
        query_or_plan,
        deadline_s: Optional[float] = None,
        plan_id: Optional[str] = None,
        _recovered: bool = False,
        idempotency_key: Optional[str] = None,
        gateway: Optional[Dict[str, Any]] = None,
        fleet: Optional[Dict[str, Any]] = None,
        trace_id: Optional[str] = None,
    ) -> PlanHandle:
        """Validate, journal and enqueue one plan; returns its handle.
        Sheds with :class:`PlanShedError` when the queue is full; a query
        that does not parse raises before anything is journaled or
        queued. ``idempotency_key`` makes the submission retry-safe (see
        the module docstring); ``gateway``, ``fleet`` and ``trace_id``
        are journaled and echoed into the plan's run report. With a lease
        directory attached the plan's lease is claimed before its record
        lands, and a plan a live peer holds raises
        :class:`PlanOwnedElsewhereError`."""
        from ..pipeline.plan import ExecutionPlan

        if self._stop.is_set():
            raise ServiceClosedError("executor is closed; no new plan admissions")
        self.start()
        plan = (query_or_plan if isinstance(query_or_plan, ExecutionPlan)
                else ExecutionPlan.parse(query_or_plan))
        # one fault plan a submission, shared by its retries
        fault_plan = runtime.resolve_fault_plan(plan)
        deadline = deadline_mod.Deadline(deadline_s) if deadline_s is not None else None
        with self._submit_lock:
            # under the lock close() drains under: a submit racing close()
            # refuses here, before any record, or lands before the drain
            if self._stop.is_set():
                raise ServiceClosedError("executor is closed; no new plan admissions")
            if _recovered and plan_id is not None:
                live = self._tickets.get(plan_id)
                if live is not None:
                    # a keyed re-submit already re-admitted this record
                    return PlanHandle(live, replayed=True)
            key_claim: Optional[lease_mod.PlanLease] = None
            if idempotency_key and not _recovered:
                existing = self._idempotency.get(idempotency_key)
                if existing is None and self.leases is not None and self.journal is not None:
                    existing, key_claim = self._resolve_fleet_key(idempotency_key)
                if existing is not None:
                    live = self._tickets.get(existing)
                    entry = (self.journal.entry(existing)
                             if self.journal is not None and live is None else None)
                    original = (live.plan.query if live is not None
                                else entry.get("query") if entry is not None else None)
                    if original is not None and original != plan.query:
                        raise IdempotencyConflictError(
                            f"idempotency key {idempotency_key!r} was already used for a "
                            f"different query (plan {existing}); retry with the original "
                            f"body or a fresh key"
                        )
                    if live is not None:
                        obs.metrics.count("scheduler.idempotent_rejoin")
                        events.event("scheduler.idempotent_rejoin", plan=existing)
                        return PlanHandle(live, replayed=True)
                    if entry is not None and entry.get("state") in (journal_mod.COMPLETED,
                                                                    journal_mod.FAILED):
                        obs.metrics.count("scheduler.idempotent_replay")
                        events.event("scheduler.idempotent_replay", plan=existing)
                        return PlanHandle(_ReplayTicket(entry), replayed=True)
                    if entry is not None:
                        # a dead process's write-ahead record: re-admit it
                        # under its own id, never shed
                        plan_id = existing
                        _recovered = True
            fresh = plan_id is None
            if fresh:
                plan_id = self._next_id()
            if self.leases is not None:
                if fresh:
                    # the lease is also the cross-process id allocator: a
                    # peer-held id, or one with a record already (a peer's
                    # finished plan holds no lease), is skipped
                    while True:
                        claim = self.leases.try_claim(plan_id)
                        if claim is lease_mod.FOREIGN_HELD:
                            plan_id = self._next_id()
                            continue
                        if self.journal is not None and self.journal.entry(plan_id) is not None:
                            if claim is not None:
                                self.leases.release(plan_id)
                            plan_id = self._next_id()
                            continue
                        break
                elif self.leases.held(plan_id) is None:
                    claim = self.leases.try_claim(plan_id)
                    if claim is lease_mod.FOREIGN_HELD:
                        info = self.leases.holder_info(plan_id)
                        holder = info["holder"] if info else None
                        raise PlanOwnedElsewhereError(
                            f"plan {plan_id} is lease-held by replica {holder!r}; this "
                            f"replica will not double-execute it",
                            plan_id=plan_id, holder=holder,
                        )
                if fleet is None:
                    fleet = {"replica": self.leases.holder, "takeover": False}
            report_dir = (None if self.report_root is None
                          else f"{self.report_root.rstrip('/')}/{plan_id}")
            ticket = _PlanTicket(plan, plan_id, deadline, fault_plan, report_dir,
                                 recovered=_recovered, idempotency_key=idempotency_key,
                                 gateway=gateway, fleet=fleet, trace_id=trace_id)
            if self.journal is not None:
                # the write-ahead record, in the plan's own fault domain
                with run_domain.activate(run_domain.RunDomain(plan_id=plan_id,
                                                              chaos=fault_plan)):
                    self.journal.record_submitted(plan_id, plan.query, meta={
                        "deadline_s": deadline_s, "report_dir": report_dir,
                        "recovered": _recovered, "idempotency_key": idempotency_key,
                        "gateway": gateway, "fleet": fleet, "trace_id": trace_id,
                    })
            if key_claim is not None:
                self.leases.release(key_claim.plan_id)
            if _recovered:
                # recovery never sheds: these plans were admitted once
                self.queue.readmit(ticket)
                admitted = True
            else:
                admitted = self.queue.offer(ticket, block_s=0.0)
                evidence = "" if admitted else self.queue.last_shed_evidence
            if admitted:
                self._tickets[plan_id] = ticket
                if idempotency_key:
                    self._idempotency[idempotency_key] = plan_id
        if not admitted:
            with run_domain.activate(run_domain.RunDomain(plan_id=plan_id, chaos=fault_plan)):
                obs.metrics.count("scheduler.shed")
                if self.journal is not None:
                    self.journal.record_failed(plan_id, plan.query,
                                               error=f"shed at admission: {evidence}",
                                               attempts=0)
            self._release_lease(plan_id)
            raise PlanShedError(f"plan {plan_id} shed at admission: {evidence}",
                                plan_id=plan_id)
        with run_domain.activate(run_domain.RunDomain(plan_id=plan_id, chaos=fault_plan)):
            obs.metrics.count("scheduler.submitted")
            events.event("scheduler.submitted", plan=plan_id)
        return PlanHandle(ticket)

    def run(self, queries, deadline_s: Optional[float] = None,
            timeout_s: Optional[float] = None) -> List[PlanResult]:
        """Submit every query and block for all results, in order. A shed
        mid-batch is backpressure: the batch waits for one of its own plans
        and retries under the shed plan's id; with none of its own in
        flight the shed is re-raised."""
        handles: List[PlanHandle] = []
        for q in queries:
            retry_id: Optional[str] = None
            while True:
                try:
                    handles.append(self.submit(q, deadline_s=deadline_s, plan_id=retry_id))
                    break
                except PlanShedError as shed:
                    retry_id = shed.plan_id or retry_id
                    in_flight = next((h for h in handles if not h.done), None)
                    if in_flight is None:
                        raise
                    try:
                        in_flight.result(timeout=timeout_s)
                    except Exception:
                        if not in_flight.done:
                            raise
        return [h.result(timeout=timeout_s) for h in handles]

    # -- status and cancel

    def status(self, plan_id: str) -> Optional[Dict[str, Any]]:
        """One plan's status: the live ticket's, else the journal record's;
        None for an unknown id."""
        ticket = self._tickets.get(plan_id)
        if ticket is not None:
            return {"plan_id": plan_id, "state": ticket.state, "attempts": ticket.attempts,
                    "history": list(ticket.history), "query": ticket.plan.query,
                    "recovered": ticket.recovered, "report_dir": ticket.report_dir,
                    "fleet": getattr(ticket, "fleet", None)}
        if self.journal is not None:
            entry = self.journal.entry(plan_id)
            if entry is not None:
                meta = entry.get("meta") or {}
                return {
                    "plan_id": plan_id,
                    "state": "cancelled" if meta.get("cancelled") else entry.get("state"),
                    "attempts": int(entry.get("attempts", 0) or 0),
                    "history": [],
                    "query": entry.get("query", ""),
                    "error": entry.get("error"),
                    "statistics_sha256": entry.get("statistics_sha256"),
                    "report_dir": meta.get("report_dir"),
                    "fleet": meta.get("fleet"),
                }
        return None

    def cancel(self, plan_id: str) -> bool:
        """Cancel-if-queued: True when the plan was withdrawn before a
        worker popped it (its handle fails with
        :class:`PlanCancelledError`, a terminal record says so and its
        idempotency key is released); False when it runs or is done."""
        ticket = self._tickets.get(plan_id)
        if ticket is None or not isinstance(ticket, _PlanTicket):
            return False
        if not self.queue.remove(ticket):
            return False
        ticket.state = "cancelled"
        with self._submit_lock:
            key = ticket.idempotency_key
            if key and self._idempotency.get(key) == plan_id:
                del self._idempotency[key]
        journaled = False
        with run_domain.activate(run_domain.RunDomain(plan_id=plan_id,
                                                      chaos=ticket.fault_plan)):
            obs.metrics.count("scheduler.cancelled")
            events.event("scheduler.cancelled", plan=plan_id)
            if self.journal is not None:
                journaled = self.journal.record_failed(
                    plan_id, ticket.plan.query,
                    "cancelled by client while queued; never executed", attempts=0,
                    meta={"cancelled": True, "gateway": ticket.gateway})
        self._release_lease(plan_id)
        ticket.future.fail(PlanCancelledError(
            f"plan {plan_id} cancelled while queued; never executed"))
        if journaled:
            self._tickets.pop(plan_id, None)
        return True

    def handle(self, plan_id: str) -> Optional[PlanHandle]:
        """The handle for a live (this-process) plan id, or None."""
        ticket = self._tickets.get(plan_id)
        return None if ticket is None else PlanHandle(ticket)

    def live_ids(self) -> List[str]:
        """Plan ids with a live ticket: queued, running, or terminal with a
        journal write that degraded (the ones the journal does not know
        yet)."""
        return list(self._tickets)

    # -- crash-only recovery

    def recover(self) -> Dict[str, Any]:
        """Resume a journaled workload after a crash: every unfinished
        record is re-submitted under its original id (``"resumed"``:
        handles to await), every terminal record is returned untouched
        (``"completed"``, ``"failed"``). Needs a ``journal_dir``."""
        if self.journal is None:
            raise ValueError("recover() needs a journal_dir — an unjournaled executor has "
                             "nothing to recover from")
        resumed: List[PlanHandle] = []
        completed: List[Dict[str, Any]] = []
        failed: List[Dict[str, Any]] = []
        for entry in self.journal.entries():
            state = entry.get("state")
            if state == journal_mod.COMPLETED:
                completed.append(entry)
            elif state == journal_mod.FAILED:
                failed.append(entry)
            elif state == journal_mod.SUBMITTED:
                meta = entry.get("meta") or {}
                try:
                    resumed.append(self.submit(
                        entry["query"], deadline_s=meta.get("deadline_s"),
                        plan_id=entry["plan_id"], _recovered=True,
                        idempotency_key=meta.get("idempotency_key"),
                        gateway=meta.get("gateway"), trace_id=meta.get("trace_id"),
                    ))
                except PlanOwnedElsewhereError:
                    continue  # a live peer holds it
        obs.metrics.count("scheduler.recovered_plans", len(resumed))
        logger.info("journal recovery: %d completed (kept), %d failed (kept), %d unfinished "
                    "re-submitted", len(completed), len(failed), len(resumed))
        return {"resumed": resumed, "completed": completed, "failed": failed}

    def claim_and_run(self, entry: Dict[str, Any], fleet: Optional[Dict[str, Any]] = None,
                      takeover: bool = True) -> Optional[PlanHandle]:
        """Lease-claim one unfinished journal record and re-admit it under
        its original id. Returns the handle when this executor won the
        claim; None when it lost (a live peer holds it, it is live here, or
        claiming is unavailable). The record is re-read under the lease,
        so a plan a peer finished meanwhile is not run again."""
        if self.journal is None or self.leases is None:
            raise ValueError("claim_and_run() needs a journal_dir and an attached lease "
                             "directory (scheduler/lease.LeaseDir)")
        plan_id = entry["plan_id"]
        if plan_id in self._tickets:
            return None
        already_held = self.leases.held(plan_id) is not None
        claim = self.leases.try_claim(plan_id, takeover=takeover)
        if not isinstance(claim, lease_mod.PlanLease):
            return None
        current = self.journal.entry(plan_id)
        if current is None or current.get("state") != journal_mod.SUBMITTED:
            if not already_held:
                self._release_lease(plan_id)
            return None
        meta = entry.get("meta") or {}
        if fleet is None:
            fleet = {"replica": self.leases.holder, "takeover": takeover}
        try:
            return self.submit(
                entry["query"], deadline_s=meta.get("deadline_s"), plan_id=plan_id,
                _recovered=True, idempotency_key=meta.get("idempotency_key"),
                gateway=meta.get("gateway"), fleet=fleet, trace_id=meta.get("trace_id"),
            )
        except Exception:
            if not already_held:
                self._release_lease(plan_id)
            raise

    def _release_lease(self, plan_id: str) -> None:
        if self.leases is not None:
            self.leases.release(plan_id)

    def drain_queued(self) -> List[str]:
        """Withdraw every still-queued plan without a terminal record: its
        record stays ``submitted``, its lease is released so a peer claims
        it at once, its handle fails with ``ServiceClosedError``. Running
        plans are untouched. Returns the released plan ids."""
        # a placement-waiting ticket a worker holds is invisible to the
        # queue.remove pass below: the flag makes the worker hand it back
        self._drain_requested = True
        with self._submit_lock:
            queued = [t for t in self._tickets.values()
                      if isinstance(t, _PlanTicket) and t.state == "queued"]
        released: List[str] = []
        for ticket in queued:
            if not self.queue.remove(ticket):
                continue  # a worker popped it meanwhile
            ticket.state = "failed"
            with self._submit_lock:
                self._tickets.pop(ticket.plan_id, None)
            self._release_lease(ticket.plan_id)
            obs.metrics.count("scheduler.drain_released")
            events.event("scheduler.drain_released", plan=ticket.plan_id)
            ticket.future.fail(ServiceClosedError(
                f"plan {ticket.plan_id} released for peer takeover during drain; its "
                f"journal record stays 'submitted'"))
            released.append(ticket.plan_id)
        return released

    # -- the worker loop

    def _worker(self) -> None:
        while not self._stop.is_set():
            batch = self.queue.collect(max_batch=1, wait_s=0.05, coalesce_s=0.0)
            if not batch:
                continue
            ticket = batch[0]
            grant = None
            if (self.placement is not None and isinstance(ticket, _PlanTicket)
                    and ticket.state == "queued"):
                placed = self._try_place(ticket)
                if placed is _PLACEMENT_WAIT:
                    if self._drain_requested:
                        self._drain_waiting_ticket(ticket)
                        continue
                    if ticket.deadline is not None and ticket.deadline.expired:
                        # fail on time, with the deadline's own evidence
                        self._execute_ticket(ticket)
                        continue
                    # back to the tail: smaller plans backfill past this
                    # footprint (the record stays submitted, the lease held)
                    self.queue.readmit(ticket)
                    self._stop.wait(self.placement_backoff_s)
                    continue
                grant = placed
            try:
                self._execute_ticket(ticket, grant=grant)
            finally:
                if grant is not None:
                    grant.release()

    def _try_place(self, ticket: _PlanTicket):
        """One placement attempt: a ``DeviceGrant``, None (run unplaced:
        exempt, larger than the pool, or the attempt raised, counted in
        ``placement.errors``) or :data:`_PLACEMENT_WAIT` (requeue)."""
        from . import placement as placement_mod

        try:
            if ticket.footprint is None:
                ticket.footprint = ticket.plan.device_footprint()
            placed = self.placement.admit(ticket.plan_id, ticket.footprint)
        except Exception as e:
            obs.metrics.count("placement.errors")
            logger.warning("placement failed for %s (%s: %s); running unplaced",
                           ticket.plan_id, type(e).__name__, e)
            return None
        if placed is placement_mod.UNPLACED:
            return None
        if placed is None:
            return _PLACEMENT_WAIT
        return placed

    def _drain_waiting_ticket(self, ticket: _PlanTicket) -> None:
        """:meth:`drain_queued`'s hand-back for a placement-waiting ticket a
        worker holds: the record stays ``submitted``, the lease is released
        for a peer, the handle fails."""
        ticket.state = "failed"
        with self._submit_lock:
            self._tickets.pop(ticket.plan_id, None)
        if self.placement is not None:
            self.placement.clear_waiting(ticket.plan_id)
        self._release_lease(ticket.plan_id)
        obs.metrics.count("scheduler.drain_released")
        events.event("scheduler.drain_released", plan=ticket.plan_id)
        ticket.future.fail(ServiceClosedError(
            f"plan {ticket.plan_id} released for peer takeover during drain; its "
            f"journal record stays 'submitted'"))

    def _execute_ticket(self, ticket: _PlanTicket, grant=None) -> None:
        from ..pipeline.builder import PipelineBuilder

        ticket.state = "running"
        if grant is not None:
            # the granted ordinals ride the fleet attribution into the run
            # report and the journal
            ticket.fleet = dict(ticket.fleet or {})
            ticket.fleet["devices"] = list(grant.ordinals)
        # a fleet-won processes=N plan (no process_id: a pod, not a member)
        # runs through the pod assist; its None runs the plan inline
        pod = ticket.plan.pod
        assist = (self.pod_assist if self.pod_assist is not None and pod is not None
                  and (pod.processes or 0) > 1 and pod.process_id is None else None)
        while True:
            if ticket.deadline is not None and ticket.deadline.expired:
                waited = time.monotonic() - ticket.submitted_at
                obs.metrics.count("scheduler.deadline_exceeded")
                if ticket.attempts == 0:
                    msg = (f"deadline ({ticket.deadline.budget_s:.3f}s budget) exceeded "
                           f"after {waited:.3f}s in the admission queue; plan was never "
                           f"executed")
                else:
                    msg = (f"deadline ({ticket.deadline.budget_s:.3f}s budget) expired "
                           f"during retry backoff after {ticket.attempts} failed; "
                           f"attempts: {ticket.history}")
                self._record_failed(ticket, msg)
                ticket.future.fail(deadline_mod.DeadlineExceededError(
                    f"plan {ticket.plan_id}: {msg}"))
                return
            # extra attribution only when set, as the JAX package passes it
            extra = {"fleet": ticket.fleet} if ticket.fleet else {}
            if ticket.trace_id:
                extra["trace_id"] = ticket.trace_id
            if grant is not None:
                extra["placement"] = grant.ordinals
            try:
                builder = PipelineBuilder(ticket.plan.query, device=self.device)
                with deadline_mod.deadline_scope(ticket.deadline):
                    statistics = assist.run(ticket) if assist is not None else None
                    if statistics is None:
                        statistics = runtime.execute_plan(
                            ticket.plan, builder, plan_id=ticket.plan_id,
                            fault_plan=ticket.fault_plan, default_report_dir=ticket.report_dir,
                            gateway=ticket.gateway, **extra)
            except Exception as e:
                ticket.attempts += 1
                ticket.history.append(f"attempt {ticket.attempts}: {type(e).__name__}: {e}")
                obs.metrics.count("scheduler.attempt_failures")
                events.event("scheduler.attempt_failed", plan=ticket.plan_id,
                              attempt=ticket.attempts, error=f"{type(e).__name__}: {e}")
                if isinstance(e, ValueError):
                    # a caller error fails the same way on every attempt
                    self._record_failed(ticket, ticket.history[-1])
                    ticket.future.fail(e)
                    return
                if ticket.attempts >= self.max_attempts:
                    self._record_failed(ticket, f"retry budget ({self.max_attempts}) "
                                                f"exhausted; attempts: {ticket.history}")
                    ticket.future.fail(PlanFailedError(
                        f"plan {ticket.plan_id} failed after {ticket.attempts} attempts "
                        f"(budget {self.max_attempts}); attempts: {ticket.history}"))
                    return
                if (ticket.deadline is not None
                        and not ticket.deadline.can_cover(self.retry_backoff_s)):
                    obs.metrics.count("scheduler.deadline_exceeded")
                    self._record_failed(ticket, f"deadline cannot cover another attempt "
                                                f"after {ticket.attempts} failed; attempts: "
                                                f"{ticket.history}")
                    ticket.future.fail(deadline_mod.DeadlineExceededError(
                        f"plan {ticket.plan_id}: deadline ({ticket.deadline.budget_s:.3f}s "
                        f"budget) cannot cover another attempt after {ticket.attempts} "
                        f"failed; attempts: {ticket.history}"))
                    return
                obs.metrics.count("scheduler.retries")
                time.sleep(self.retry_backoff_s)
                continue
            ticket.attempts += 1
            journaled = False
            if self.journal is not None:
                with run_domain.activate(run_domain.RunDomain(plan_id=ticket.plan_id,
                                                              chaos=ticket.fault_plan)):
                    journaled = self.journal.record_completed(
                        ticket.plan_id, ticket.plan.query, str(statistics),
                        attempts=ticket.attempts,
                        meta={"recovered": ticket.recovered,
                              "idempotency_key": ticket.idempotency_key,
                              "gateway": ticket.gateway, "fleet": ticket.fleet,
                              "report_dir": ticket.report_dir, "trace_id": ticket.trace_id})
            self._release_lease(ticket.plan_id)
            obs.metrics.count("scheduler.completed")
            events.event("scheduler.completed", plan=ticket.plan_id, attempts=ticket.attempts)
            ticket.state = "completed"
            ticket.future.resolve(PlanResult(
                plan_id=ticket.plan_id, statistics=statistics, builder=builder,
                attempts=ticket.attempts, report_dir=ticket.report_dir,
                recovered=ticket.recovered))
            if journaled:
                # the durable record landed: the journal answers for it now
                self._tickets.pop(ticket.plan_id, None)
            return

    def _record_failed(self, ticket: _PlanTicket, error: str) -> None:
        ticket.state = "failed"
        self._release_lease(ticket.plan_id)
        obs.metrics.count("scheduler.failed")
        if self.journal is not None:
            with run_domain.activate(run_domain.RunDomain(plan_id=ticket.plan_id,
                                                          chaos=ticket.fault_plan)):
                journaled = self.journal.record_failed(
                    ticket.plan_id, ticket.plan.query, error, attempts=ticket.attempts,
                    meta={"idempotency_key": ticket.idempotency_key, "gateway": ticket.gateway,
                          "fleet": ticket.fleet, "report_dir": ticket.report_dir,
                          "trace_id": ticket.trace_id})
            if journaled:
                self._tickets.pop(ticket.plan_id, None)
