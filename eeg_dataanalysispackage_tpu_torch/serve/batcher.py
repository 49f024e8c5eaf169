"""Micro-batching with admission control, deadlines and a watchdog.

Port of the JAX package's ``serve/batcher.py``. The front end between
callers and the serving engine (serve/engine.py); each failure mode has
an explicit owner:

- **Bounded admission queue** — a burst past ``queue_depth`` is shed
  at the door with :class:`ShedError` carrying evidence (depth, limit,
  age of the oldest queued request). Never an unbounded queue, never a
  silent drop.
- **Per-request deadlines** — every request carries an
  :class:`io.deadline.Deadline`. A request whose budget is spent while
  queued fails fast with the time it waited.
- **Deadline-aware retries** — a failed micro-batch retries with
  backoff, but a request is only re-attempted while its remaining
  budget covers the next backoff; otherwise it fails now with its full
  attempt history.
- **Watchdog** — a wedged batcher thread (an execute call that never
  returns) is detected by heartbeat age; every queued and in-flight
  request is failed fast with :class:`ServiceWedgedError` and new
  submissions are rejected.
- **Graceful drain** — closing stops admissions (rejected with
  :class:`ServiceClosedError`) while everything already admitted
  completes.

- **Tenants** (multi-tenant services, serve/multiplex.py) — a request
  may carry a tenant; the tenant is not in the batch key, so mixed
  tenants coalesce into one batch. A per-tenant quota sheds one
  tenant's burst against its own budget, with that tenant's depth and
  oldest age as evidence, and a tenant-aware batcher keeps per-tenant
  outcome counters, latency reservoirs and histograms.

Counters and latencies live in the batcher's own snapshot. The
batcher and watchdog threads adopt the run domain of the thread that
starts them, so a run's ``faults=`` plan and span recorder reach them:
the chaos points ``serve.request`` (one admitted request: it is
re-admitted, or failed with its history), ``serve.batch.tenant.<name>``
(one tenant's rows of a mixed batch, each re-admitted or failed alone)
and ``serve.batch`` (one batch execution, inside a ``serve.batch``
span: the batch retry path) fire here, as in the JAX package.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Callable, List, Optional

from ..io import deadline as deadline_mod
from ..obs import chaos, domain as run_domain, events, metrics_export

logger = logging.getLogger(__name__)


class ServeError(RuntimeError):
    """Base class for serving-path failures."""


class ShedError(ServeError):
    """Admission control rejected the request (queue full).

    ``evidence`` carries the structured shed record (depth, limit,
    oldest age) alongside the human-readable message."""

    def __init__(self, message: str, evidence: Optional[dict] = None):
        super().__init__(message)
        self.evidence = evidence or {}


class ServiceClosedError(ServeError):
    """The service is draining or stopped; no new admissions."""


class ServiceWedgedError(ServeError):
    """The batcher thread wedged; the request was failed fast by the
    watchdog instead of hanging its caller."""


class RequestFailedError(ServeError):
    """The request exhausted its retry/deadline budget; the message
    carries the per-attempt history."""


class UnknownTenantError(ValueError):
    """A batch holds requests of tenants that are not registered, e.g.
    removed after the requests were admitted; ``tenants`` names them. A
    tenant-aware batcher fails those requests alone and runs the rest
    of the batch."""

    def __init__(self, tenants):
        self.tenants = frozenset(tenants)
        super().__init__(
            "unknown tenant " + ", ".join(repr(t) for t in sorted(self.tenants))
        )


class ServeFuture:
    """Resolve-once future for one serving request.

    Resolution is guarded by a per-future lock: the batcher finishing
    a slow batch races the watchdog (and ``stop()``) failing the same
    request, and exactly one of them may win — the loser's return value
    steers the outcome accounting.
    """

    __slots__ = ("_event", "_value", "_error", "_lock")

    def __init__(self):
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()

    def resolve(self, value: Any) -> bool:
        """First resolution wins; returns whether this call was the one
        that resolved it."""
        with self._lock:
            if self._event.is_set():
                return False
            self._value = value
            self._event.set()
            return True

    def fail(self, error: BaseException) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._error = error
            self._event.set()
            return True

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block for the outcome. The watchdog guarantees every
        admitted request resolves; ``timeout`` is an extra caller-side
        bound."""
        if not self._event.wait(timeout):
            raise TimeoutError("serve request still unresolved")
        if self._error is not None:
            raise self._error
        return self._value


class Request:
    """One admitted serving request."""

    __slots__ = (
        "window", "resolutions", "deadline", "future", "submitted_at",
        "attempts", "history", "tenant",
    )

    def __init__(self, window, resolutions, deadline, tenant=None):
        self.window = window
        self.resolutions = resolutions
        self.deadline: deadline_mod.Deadline = deadline
        self.future = ServeFuture()
        self.submitted_at = time.monotonic()
        self.attempts = 0
        self.history: List[str] = []
        #: owning tenant (multi-tenant services); None for single-model
        #: services. Not part of batch_key: mixed-tenant requests
        #: coalesce into one batch
        self.tenant: Optional[str] = tenant

    def batch_key(self):
        """Requests coalesce only when the engine can run them as one
        stream: same dtype, same per-channel resolutions. The tenant is
        not here: the multi-tenant engine picks each row's weights by
        lane, so one batch mixes tenants freely."""
        return (self.window.dtype.str, self.resolutions.tobytes())


class Result:
    """A successful prediction, with its serving provenance."""

    __slots__ = ("prediction", "margin", "latency_s", "batch_size",
                 "attempts")

    def __init__(self, prediction, margin, latency_s, batch_size,
                 attempts):
        self.prediction = prediction
        self.margin = margin
        self.latency_s = latency_s
        self.batch_size = batch_size
        self.attempts = attempts

    def __repr__(self) -> str:
        return (
            f"Result(prediction={self.prediction}, "
            f"latency_s={self.latency_s:.4f}, "
            f"batch_size={self.batch_size}, attempts={self.attempts})"
        )


class AdmissionQueue:
    """Bounded FIFO with explicit shedding and batch coalescing.

    ``queue.Queue`` hides its deque; coalescing (pop a run of requests
    sharing a batch key) and retry re-admission (which must not be
    shed — the request was already accepted once) both need direct
    access, so this is a small purpose-built structure.
    """

    def __init__(self, depth: int, tenant_quota: Optional[int] = None):
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        if tenant_quota is not None and tenant_quota < 1:
            raise ValueError(f"tenant_quota must be >= 1, got {tenant_quota}")
        self.depth = int(depth)
        #: per-tenant cap on queued requests (multi-tenant services): one
        #: noisy tenant fills its quota and sheds, with its own evidence,
        #: while the shared queue keeps admitting the others. None checks
        #: only the global depth.
        self.tenant_quota = None if tenant_quota is None else int(tenant_quota)
        self._items: "collections.deque" = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        #: human-readable evidence for the most recent shed decision
        self._last_shed_evidence = ""
        #: structured twin of the evidence line (depths, ages)
        self._last_shed_details: dict = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def last_shed_evidence(self) -> str:
        """Human-readable evidence for the most recent shed decision."""
        with self._lock:
            return self._last_shed_evidence

    @property
    def last_shed_details(self) -> dict:
        """Structured evidence for the most recent shed decision —
        ``{"reason", "queue_depth", "depth_limit", "oldest_age_s"}``,
        plus ``{"tenant", "tenant_depth", "tenant_quota"}`` when a
        per-tenant quota shed the request."""
        with self._lock:
            return dict(self._last_shed_details)

    def _admissible(self, request: Request) -> bool:
        """Room in the queue and in the request's tenant quota (caller
        holds the lock)."""
        if len(self._items) >= self.depth:
            return False
        if self.tenant_quota is None or request.tenant is None:
            return True
        depth = sum(1 for item in self._items if item.tenant == request.tenant)
        return depth < self.tenant_quota

    def _record_shed(self, request: Request) -> None:
        """The evidence of a shed decision (caller holds the lock)."""
        now = time.monotonic()
        if len(self._items) >= self.depth:
            oldest_age = now - self._items[0].submitted_at
            self._last_shed_details = {
                "reason": "queue_full",
                "queue_depth": len(self._items),
                "depth_limit": self.depth,
                "oldest_age_s": round(oldest_age, 3),
            }
            self._last_shed_evidence = (
                f"queue at depth {self.depth}, oldest "
                f"queued request is {oldest_age:.3f}s old"
            )
            return
        tenant = request.tenant
        tenant_items = [item for item in self._items if item.tenant == tenant]
        oldest_age = now - tenant_items[0].submitted_at if tenant_items else 0.0
        self._last_shed_details = {
            "reason": "tenant_quota",
            "tenant": tenant,
            "tenant_depth": len(tenant_items),
            "tenant_quota": self.tenant_quota,
            "queue_depth": len(self._items),
            "depth_limit": self.depth,
            "oldest_age_s": round(oldest_age, 3),
        }
        self._last_shed_evidence = (
            f"tenant {tenant!r} at its quota of {self.tenant_quota} queued "
            f"requests (queue holds {len(self._items)}/{self.depth}); "
            f"{tenant!r}'s oldest queued request is {oldest_age:.3f}s old"
        )

    def offer(self, request: Request, block_s: float = 0.0) -> bool:
        """Admit one request; False = full (the caller sheds). With
        ``block_s`` the caller cooperates with backpressure by waiting
        (on the pop-notified condition — no polling) for space.

        With a ``tenant_quota``, a tenant's request is also refused while
        that tenant already has ``tenant_quota`` requests queued: its
        burst sheds against its own quota while the queue keeps
        admitting the other tenants."""
        deadline = time.monotonic() + block_s
        with self._not_full:
            while not self._admissible(request):
                remaining = deadline - time.monotonic()
                if remaining <= 0.0:
                    self._record_shed(request)
                    return False
                self._not_full.wait(remaining)
            self._items.append(request)
            self._not_empty.notify()
            return True

    def readmit(self, request: Request) -> None:
        """Put a retrying request back WITHOUT the depth check: it was
        admitted once and must not be shed mid-retry (the bound on
        re-admissions is the retry budget itself)."""
        with self._lock:
            self._items.append(request)
            self._not_empty.notify()

    def collect(
        self, max_batch: int, wait_s: float, coalesce_s: float,
        claim=None, flush_s: float = 0.0,
    ) -> List[Request]:
        """Pop the next micro-batch: up to ``max_batch`` consecutive
        requests sharing a batch key. Waits up to ``wait_s`` for the
        first request, then up to ``coalesce_s`` more for the batch to
        fill — latency spent deliberately to buy throughput, bounded
        so an idle trickle still flows.

        ``flush_s`` (the ``serve_flush_us=`` knob, seconds here) is a
        further bounded coalescing window AFTER a request is waiting:
        the pop holds until the head-key run holds a full ``max_batch``
        or the window closes, waiting on the offer-notified condition.
        0 (the default) skips the window.

        ``claim(batch)`` runs under the queue lock, in the same
        critical section that pops the items: the batcher registers
        the batch as in-flight there, so a drain watcher can never
        observe requests in neither the queue nor the in-flight set.
        """
        with self._not_empty:
            if not self._items:
                self._not_empty.wait(wait_s)
            if not self._items:
                return []
            if flush_s > 0.0:
                # the predicate counts the HEAD-KEY RUN, not the raw
                # queue length: the pop below stops at the first
                # batch-key boundary, so key-incompatible arrivals can
                # never fill the bucket
                def head_run() -> int:
                    key = self._items[0].batch_key()
                    n = 0
                    for item in self._items:
                        if item.batch_key() != key:
                            break
                        n += 1
                    return n

                fill_deadline = time.monotonic() + flush_s
                # the wait releases the lock, and a shutdown/watchdog
                # drain_pending() may empty the queue meanwhile
                while self._items and head_run() < max_batch:
                    remaining = fill_deadline - time.monotonic()
                    if remaining <= 0.0:
                        break
                    self._not_empty.wait(remaining)
        if coalesce_s > 0.0:
            fill_deadline = time.monotonic() + coalesce_s
            while time.monotonic() < fill_deadline:
                with self._lock:
                    if len(self._items) >= max_batch:
                        break
                time.sleep(0.001)
        batch: List[Request] = []
        with self._lock:
            while self._items and len(batch) < max_batch:
                if batch and (
                    self._items[0].batch_key() != batch[0].batch_key()
                ):
                    break  # different stream config: next batch's job
                batch.append(self._items.popleft())
            if claim is not None and batch:
                claim(batch)
            if batch:
                self._not_full.notify(len(batch))
        return batch

    def remove(self, request: Request) -> bool:
        """Withdraw one still-queued item (the plan executor's
        cancel-if-queued): True when it was queued and is gone, False when
        a worker already popped it. The pop path shares the lock, so an
        item is removed or collected, never both."""
        with self._lock:
            try:
                self._items.remove(request)
            except ValueError:
                return False
            self._not_full.notify()
            return True

    def drain_pending(self) -> List[Request]:
        """Remove and return everything queued (watchdog / shutdown)."""
        with self._lock:
            items = list(self._items)
            self._items.clear()
            self._not_full.notify_all()
            return items


class MicroBatcher:
    """The batcher thread plus its watchdog.

    ``execute(windows, resolutions) -> (predictions, margins)`` is the
    engine seam (injectable for tests — a wedged executor is how the
    watchdog is proven). A ``tenant_aware`` batcher (multi-tenant
    services) calls ``execute(windows, resolutions, tenants)`` instead,
    and keeps per-tenant outcome counters (``tenant.<name>.<key>``), a
    per-tenant latency reservoir and a per-tenant latency histogram.
    """

    def __init__(
        self,
        execute: Callable,
        max_batch: int,
        queue_depth: int,
        coalesce_s: float = 0.002,
        flush_us: int = 0,
        max_attempts: int = 3,
        retry_backoff_s: float = 0.05,
        watchdog_s: float = 5.0,
        name: str = "serve",
        tenant_aware: bool = False,
        tenant_quota: Optional[int] = None,
    ):
        if flush_us < 0:
            raise ValueError(f"flush_us must be >= 0, got {flush_us}")
        self._execute = execute
        self.tenant_aware = bool(tenant_aware)
        self.max_batch = int(max_batch)
        self.queue = AdmissionQueue(queue_depth, tenant_quota=tenant_quota)
        self.coalesce_s = float(coalesce_s)
        #: the bounded batch-fill window in seconds (serve_flush_us=)
        self.flush_s = int(flush_us) / 1e6
        self.max_attempts = int(max_attempts)
        self.retry_backoff_s = float(retry_backoff_s)
        self.watchdog_s = float(watchdog_s)
        self.name = name
        self._stop = threading.Event()
        self.wedged = threading.Event()
        self._heartbeat = time.monotonic()
        self._in_flight: List[Request] = []
        self._in_flight_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._watchdog_thread: Optional[threading.Thread] = None
        #: bounded latency reservoir for percentiles (seconds)
        self.latencies: "collections.deque" = collections.deque(maxlen=8192)
        #: fixed-bucket latency histogram (obs/metrics_export.py): never
        #: evicts; the SLO block reads it
        self.latency_hist = metrics_export.LatencyHistogram()
        #: per-tenant latency reservoirs and histograms (tenant-aware
        #: batchers), guarded by the counters lock
        self.tenant_latencies: dict = {}
        self.tenant_latency_hists: dict = {}
        self.counters = collections.Counter()
        self._counters_lock = threading.Lock()

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        # both threads adopt the starter's run domain: its fault plan and
        # span recorder
        domain = run_domain.capture()
        self._thread = threading.Thread(
            target=lambda: self._adopted(domain, self._run),
            name=f"eeg-{self.name}-batcher", daemon=True,
        )
        self._thread.start()
        self._watchdog_thread = threading.Thread(
            target=lambda: self._adopted(domain, self._watchdog_run),
            name=f"eeg-{self.name}-watchdog", daemon=True,
        )
        self._watchdog_thread.start()

    @staticmethod
    def _adopted(domain, body) -> None:
        with run_domain.adopt(domain):
            body()

    def stop(self, join_timeout_s: float = 5.0) -> None:
        self._stop.set()
        for t in (self._thread, self._watchdog_thread):
            if t is not None:
                t.join(timeout=join_timeout_s)

    def wait_idle(self, timeout_s: float) -> bool:
        """Block until nothing is queued or in flight (drain). True =
        drained; False = the timeout (or a wedge) cut the wait."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.wedged.is_set():
                return False
            with self._in_flight_lock:
                in_flight = len(self._in_flight)
            if in_flight == 0 and len(self.queue) == 0:
                return True
            time.sleep(0.005)
        return False

    def count(self, key: str, n: int = 1) -> None:
        with self._counters_lock:
            self.counters[key] += n

    def _count_tenant(self, tenant, key: str, n: int = 1) -> None:
        """Per-tenant counter ``tenant.<name>.<key>``; the global key is
        counted separately by :meth:`count`. Per-tenant keys are bounded
        by the stack's 128 lanes, not by traffic."""
        if tenant is None:
            return
        with self._counters_lock:
            self.counters[f"tenant.{tenant}.{key}"] += n

    def _tenant_latency(self, tenant, latency: float) -> None:
        if tenant is None:
            return
        with self._counters_lock:
            reservoir = self.tenant_latencies.get(tenant)
            if reservoir is None:
                reservoir = collections.deque(maxlen=8192)
                self.tenant_latencies[tenant] = reservoir
            reservoir.append(latency)
            hist = self.tenant_latency_hists.get(tenant)
            if hist is None:
                hist = metrics_export.LatencyHistogram()
                self.tenant_latency_hists[tenant] = hist
            hist.observe(latency * 1e3)

    def tenant_latency_snapshot(self) -> dict:
        """Per-tenant latency reservoir copies under the lock (empty for
        tenant-unaware batchers)."""
        with self._counters_lock:
            return {t: list(r) for t, r in self.tenant_latencies.items()}

    def tenant_histogram_snapshot(self) -> dict:
        """Per-tenant latency histogram copies under the lock (empty for
        tenant-unaware batchers)."""
        with self._counters_lock:
            return {
                t: metrics_export.LatencyHistogram.from_snapshot(h.snapshot())
                for t, h in self.tenant_latency_hists.items()
            }

    def evict_tenant(self, tenant: str) -> None:
        """Drop a departed tenant's reservoir, histogram and
        ``tenant.<name>.*`` counters, so add/remove churn does not grow
        them for the service's lifetime."""
        prefix = f"tenant.{tenant}."
        with self._counters_lock:
            self.tenant_latencies.pop(tenant, None)
            self.tenant_latency_hists.pop(tenant, None)
            for key in [k for k in self.counters if k.startswith(prefix)]:
                del self.counters[key]

    def snapshot(self):
        """(counters copy, latency list) under the lock — the safe
        read surface for a live service's stats."""
        with self._counters_lock:
            return dict(self.counters), list(self.latencies)

    def histogram_snapshot(self) -> metrics_export.LatencyHistogram:
        """A point-in-time copy of the latency histogram, taken under
        the counters lock."""
        with self._counters_lock:
            return metrics_export.LatencyHistogram.from_snapshot(
                self.latency_hist.snapshot()
            )

    def in_flight(self) -> List[Request]:
        with self._in_flight_lock:
            return list(self._in_flight)

    # -- the batcher loop ----------------------------------------------

    def _claim(self, batch: List[Request]) -> None:
        """Runs inside the queue's pop critical section (see
        AdmissionQueue.collect): requests move atomically from queued
        to in-flight, so wait_idle can't declare a drain complete
        while a batch sits in the batcher's hands."""
        with self._in_flight_lock:
            self._in_flight = list(batch)

    def _run(self) -> None:
        while not self._stop.is_set():
            self._heartbeat = time.monotonic()
            batch = self.queue.collect(
                self.max_batch, wait_s=0.05,
                coalesce_s=self.coalesce_s, claim=self._claim,
                flush_s=self.flush_s,
            )
            if not batch:
                continue
            self._heartbeat = time.monotonic()
            try:
                self._process(batch)
            finally:
                with self._in_flight_lock:
                    self._in_flight = []

    def _process(self, batch: List[Request]) -> None:
        # 1. queued-too-long: a request whose budget died in the queue
        # fails now with the time it waited — running it would waste a
        # batch slot producing an answer nobody is waiting for
        live: List[Request] = []
        for req in batch:
            if req.deadline.expired:
                waited = time.monotonic() - req.submitted_at
                self.count("deadline_exceeded")
                self._count_tenant(req.tenant, "deadline_exceeded")
                req.future.fail(deadline_mod.DeadlineExceededError(
                    f"deadline ({req.deadline.budget_s:.3f}s budget) "
                    f"exceeded after {waited:.3f}s in the admission "
                    f"queue; request was never executed"
                ))
                continue
            # 2. per-request chaos: one admitted request fails inside the
            # batcher; it retries or fails with evidence, never hangs
            try:
                chaos.maybe_fire("serve.request")
            except Exception as e:
                self._retry_or_fail(req, e)
                continue
            live.append(req)
        if not live:
            return
        # 2b. tenant-scoped batch chaos: serve.batch.tenant.<name> fails
        # one tenant's rows of the mixed batch, each retried or failed
        # alone, while the other tenants' rows run untouched
        if self.tenant_aware:
            failed_tenants = {}
            for tenant in {r.tenant for r in live if r.tenant}:
                try:
                    chaos.maybe_fire(f"{chaos.TENANT_BATCH_PREFIX}{tenant}")
                except Exception as e:
                    failed_tenants[tenant] = e
            if failed_tenants:
                survivors = []
                for req in live:
                    if req.tenant in failed_tenants:
                        self._retry_or_fail(req, failed_tenants[req.tenant])
                    else:
                        survivors.append(req)
                live = survivors
                if not live:
                    return
        # 3. execute, with deadline-aware retries
        while True:
            self._heartbeat = time.monotonic()
            try:
                args = ([r.window for r in live], live[0].resolutions)
                if self.tenant_aware:
                    args += ([r.tenant for r in live],)
                with events.span("serve.batch", size=len(live), attempt=live[0].attempts + 1):
                    chaos.maybe_fire("serve.batch")
                    predictions, margins = self._execute(*args)
            except Exception as e:
                gone = [r for r in live if isinstance(e, UnknownTenantError)
                        and r.tenant in e.tenants]
                if gone:
                    # tenants removed after their requests were admitted:
                    # those requests fail alone, the rest runs at once
                    for req in gone:
                        self.count("failed")
                        req.future.fail(RequestFailedError(
                            f"tenant {req.tenant!r} was removed before the "
                            f"request ran"
                        ))
                    live = [r for r in live if r not in gone]
                    if not live:
                        return
                    continue
                self.count("batch_failures")
                for req in live:
                    req.history.append(
                        f"attempt {req.attempts + 1}: "
                        f"{type(e).__name__}: {e}"
                    )
                    req.attempts += 1
                survivors = []
                for req in live:
                    if req.attempts >= self.max_attempts:
                        self._fail_exhausted(req)
                    elif not req.deadline.can_cover(self.retry_backoff_s):
                        self._fail_deadline(req)
                    else:
                        survivors.append(req)
                if not survivors:
                    return
                live = survivors
                self.count("retries", len(live))
                for req in live:
                    self._count_tenant(req.tenant, "retries")
                time.sleep(self.retry_backoff_s)
                continue
            now = time.monotonic()
            self.count("batches")
            delivered = 0
            for i, req in enumerate(live):
                latency = now - req.submitted_at
                won = req.future.resolve(Result(
                    prediction=float(predictions[i]),
                    margin=(
                        None if margins is None else float(margins[i])
                    ),
                    latency_s=latency,
                    batch_size=len(live),
                    attempts=req.attempts + 1,
                ))
                if not won:
                    # the watchdog (or a drain-timeout stop) already
                    # failed this future: the caller never saw this
                    # answer, so it must not inflate 'completed' or
                    # the latency reservoir
                    continue
                delivered += 1
                self._count_tenant(req.tenant, "completed")
                self._tenant_latency(req.tenant, latency)
                with self._counters_lock:
                    self.latencies.append(latency)
                    self.latency_hist.observe(latency * 1e3)
            if delivered:
                self.count("completed", delivered)
            return

    def _retry_or_fail(self, req: Request, error: Exception) -> None:
        """One request failed on its own: re-admitted while the retry
        and deadline budgets allow, else failed with its history."""
        req.attempts += 1
        req.history.append(f"attempt {req.attempts}: {type(error).__name__}: {error}")
        if req.attempts >= self.max_attempts:
            self._fail_exhausted(req)
        elif req.deadline.expired:
            self._fail_deadline(req)
        else:
            self.count("retries")
            self._count_tenant(req.tenant, "retries")
            events.event("serve.retry", attempts=req.attempts)
            self.queue.readmit(req)

    def _fail_exhausted(self, req: Request) -> None:
        self.count("failed")
        self._count_tenant(req.tenant, "failed")
        req.future.fail(RequestFailedError(
            f"request failed after {req.attempts} attempts "
            f"(budget {self.max_attempts}); attempts: {req.history}"
        ))

    def _fail_deadline(self, req: Request) -> None:
        self.count("deadline_exceeded")
        self._count_tenant(req.tenant, "deadline_exceeded")
        req.future.fail(deadline_mod.DeadlineExceededError(
            f"deadline ({req.deadline.budget_s:.3f}s budget) cannot "
            f"cover another attempt after {req.attempts} failed; "
            f"attempts: {req.history}"
        ))

    # -- the watchdog ---------------------------------------------------

    def _watchdog_run(self) -> None:
        poll = max(0.01, self.watchdog_s / 4.0)
        # waiting on the stop event, not sleeping, lets stop() join at once
        while not self._stop.wait(poll):
            if self.wedged.is_set():
                # the trip already happened, but a submitter that was
                # blocked in offer() at trip time can still land a
                # request in the drained queue — keep sweeping so no
                # admitted future is ever left unresolved
                for req in self.queue.drain_pending():
                    req.future.fail(ServiceWedgedError(
                        "request failed fast: service is wedged "
                        "(watchdog tripped earlier)"
                    ))
                continue
            in_flight = self.in_flight()
            busy = bool(in_flight) or len(self.queue) > 0
            age = time.monotonic() - self._heartbeat
            if busy and age > self.watchdog_s:
                self.wedged.set()
                self.count("watchdog_trips")
                evidence = (
                    f"batcher heartbeat is {age:.1f}s old "
                    f"(watchdog_s={self.watchdog_s}); "
                    f"{len(in_flight)} in flight, "
                    f"{len(self.queue)} queued"
                )
                logger.error(
                    "serve.watchdog tripped: %s — failing all pending "
                    "requests fast", evidence,
                )
                for req in in_flight + self.queue.drain_pending():
                    req.future.fail(ServiceWedgedError(
                        f"request failed fast by the watchdog: "
                        f"{evidence}"
                    ))
