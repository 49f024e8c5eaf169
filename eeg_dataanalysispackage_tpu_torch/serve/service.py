"""The resident P300 inference service.

Port of the JAX package's ``serve/service.py`` for single-model
services. Loads a saved classifier once, builds and checks the serving
kernels once (serve/engine.py), and serves prediction requests through
the micro-batching front end (serve/batcher.py) until drained. A
request admitted here resolves — answer, shed, deadline-exceeded, or
fail-fast on a wedge — it never hangs its caller, and the queue never
grows without bound.

Typical use::

    with InferenceService.from_saved("logreg", "/models/p300") as svc:
        result = svc.predict_window(window_i16, resolutions)
        # or async:
        fut = svc.submit(window_i16, resolutions, deadline_s=0.5)
        result = fut.result()

Closing the context drains gracefully: in-flight requests complete,
new ones are rejected with :class:`serve.batcher.ServiceClosedError`.
Many tenants' models behind one engine: :class:`serve.multiplex.MultiplexedService`,
a subclass. A service built with ``lifecycle=LifecycleConfig(...)``
adapts its model to labeled feedback (``submit(..., label=)``,
:meth:`InferenceService.feedback`; serve/lifecycle.py).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from . import batcher as batcher_mod
from . import engine as engine_mod
from . import lifecycle as lifecycle_mod
from ..io import deadline as deadline_mod
from ..models import registry as clf_registry
from ..obs import metrics_export
from ..utils import constants

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs; all bounded, all with shed-don't-stall defaults.

    ``max_batch`` is also the engine's static capacity (rounded up to
    64) — every batch size from 1 to it runs the same shapes.
    """

    max_batch: int = 64
    queue_depth: int = 256
    coalesce_s: float = 0.002
    #: bounded coalescing window (microseconds): with a request already
    #: waiting, the batcher holds dispatch up to this long for queued
    #: compatible requests to fill the bucket. 0 (the default) skips it.
    flush_us: int = 0
    #: per-tenant admission budget of a multi-tenant service
    #: (serve/multiplex.py): at most this many of one tenant's requests
    #: queued at once, so one noisy tenant sheds against its own budget
    #: instead of starving the shared queue. None (the default, and the
    #: only meaningful value for a single-model service) disables it.
    tenant_quota: Optional[int] = None
    default_deadline_s: float = 2.0
    max_attempts: int = 3
    retry_backoff_s: float = 0.05
    watchdog_s: float = 5.0
    drain_timeout_s: float = 10.0
    #: the latency objective (milliseconds) the SLO block scores
    #: attainment against
    slo_latency_ms: float = 50.0
    #: the availability objective: completed / admitted
    slo_availability_target: float = 0.999


def _percentile(sorted_values: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_values:
        return 0.0
    idx = min(
        len(sorted_values) - 1,
        max(0, int(round(q / 100.0 * (len(sorted_values) - 1)))),
    )
    return sorted_values[idx]


class InferenceService:
    """One loaded model + one micro-batching loop + one watchdog, on
    ``device`` (``None`` -> ``cuda``; raises without a card)."""

    def __init__(
        self,
        classifier,
        wavelet_index: int = 8,
        n_channels: int = len(constants.CHANNEL_NAMES),
        pre: int = constants.PRESTIMULUS_SAMPLES,
        post: int = constants.POSTSTIMULUS_SAMPLES,
        config: Optional[ServeConfig] = None,
        host_extractor=None,
        precision: str = "f32",
        engine_rung: str = "auto",
        device: Optional[Union[str, torch.device]] = None,
        lifecycle: Optional[lifecycle_mod.LifecycleConfig] = None,
    ):
        self.config = config or ServeConfig()
        self._attach(engine_mod.ServingEngine(
            classifier,
            wavelet_index=wavelet_index,
            n_channels=n_channels,
            pre=pre,
            post=post,
            capacity=self.config.max_batch,
            host_extractor=host_extractor,
            precision=precision,
            engine_rung=engine_rung,
            device=device,
        ))
        #: the model lifecycle manager (serve/lifecycle.py): partial fit
        #: on labeled feedback, shadow-scored hot swap, drift detection;
        #: None unless the service was built with a LifecycleConfig
        self.lifecycle = (
            None if lifecycle is None
            else lifecycle_mod.LifecycleManager(self.engine, lifecycle)
        )

    def _attach(self, engine, **batcher_kwargs) -> None:
        """Serve ``engine`` through a micro-batcher configured from
        :attr:`config` (``batcher_kwargs`` add the tenant options)."""
        self.engine = engine
        self.lifecycle: Optional[lifecycle_mod.LifecycleManager] = None
        self.batcher = batcher_mod.MicroBatcher(
            engine.execute,
            max_batch=self.config.max_batch,
            queue_depth=self.config.queue_depth,
            coalesce_s=self.config.coalesce_s,
            flush_us=self.config.flush_us,
            max_attempts=self.config.max_attempts,
            retry_backoff_s=self.config.retry_backoff_s,
            watchdog_s=self.config.watchdog_s,
            **batcher_kwargs,
        )
        self._accepting = False
        self._started = False
        self._drained_cleanly: Optional[bool] = None
        self._lock = threading.Lock()

    @classmethod
    def from_saved(
        cls,
        classifier_name: str,
        model_path: str,
        warmup: bool = True,
        **kwargs,
    ) -> "InferenceService":
        """Load ``classifier_name`` from ``model_path`` exactly once,
        build the service around it, and (by default) build and check
        the serving kernels before any traffic."""
        classifier = clf_registry.create(classifier_name)
        classifier.load(model_path)
        service = cls(classifier, **kwargs)
        if warmup:
            service.engine.warmup()
        return service

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "InferenceService":
        # build and check the kernels before traffic (idempotent —
        # from_saved already did it): a cold nvcc build must happen
        # here, not inside the batcher where the watchdog would read it
        # as a wedge, nor on the lifecycle's adapter thread
        self.engine.warmup()
        with self._lock:
            if self._started:
                return self
            self.batcher.start()
            if self.lifecycle is not None:
                self.lifecycle.start()
            self._accepting = True
            self._started = True
        logger.info(
            "inference service started (%s, rung %s, max_batch=%d, "
            "queue_depth=%d)", self.engine.mode, self.engine.rung,
            self.config.max_batch, self.config.queue_depth,
        )
        return self

    def stop(self, drain: bool = True) -> bool:
        """Shut down. With ``drain`` (default) the service stops
        admitting, lets everything already admitted complete (bounded
        by ``drain_timeout_s``), then stops the threads. Returns True
        iff the drain completed cleanly."""
        with self._lock:
            if not self._started:
                return True
            self._accepting = False
        drained = True
        if drain:
            drained = self.batcher.wait_idle(self.config.drain_timeout_s)
            if not drained:
                logger.warning(
                    "serve drain incomplete after %.1fs (%d queued, "
                    "wedged=%s)", self.config.drain_timeout_s,
                    len(self.batcher.queue), self.batcher.wedged.is_set(),
                )
        self.batcher.stop()
        # anything still pending after a failed (or skipped) drain
        # resolves now — the no-hanging-caller contract survives
        # shutdown too; resolve-once semantics make a race with the
        # request's own batch benign
        for req in self.batcher.in_flight() + self.batcher.queue.drain_pending():
            req.future.fail(batcher_mod.ServiceClosedError(
                "service stopped before the request could complete"
            ))
        if self.lifecycle is not None:
            # a clean drain also adapts on the queued feedback; an abort
            # (drain=False or a failed drain) does not train through the
            # backlog, and the adapter never outlives the service
            self.lifecycle.close(
                flush=drain and drained, timeout_s=self.config.drain_timeout_s,
            )
        with self._lock:
            self._started = False
        self._drained_cleanly = drained
        return drained

    def __enter__(self) -> "InferenceService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)

    # -- request path ---------------------------------------------------

    def submit(
        self,
        window: np.ndarray,
        resolutions: np.ndarray,
        deadline_s: Optional[float] = None,
        block_s: float = 0.0,
        label: Optional[float] = None,
    ) -> batcher_mod.ServeFuture:
        """Admit one request; returns its future.

        ``label`` (a lifecycle-enabled service only) is the request's
        known true target, forwarded as feedback to the lifecycle
        manager; when the label is known only later, call
        :meth:`feedback`.

        Raises :class:`ShedError` when the bounded queue is full (pass
        ``block_s`` to cooperate with backpressure instead),
        :class:`ServiceClosedError` when draining/stopped, and
        :class:`ServiceWedgedError` when the watchdog has declared the
        batcher wedged — all synchronously, with evidence.
        """
        if label is not None and self.lifecycle is None:
            raise ValueError(
                "submit(label=) needs a lifecycle-enabled service "
                "(adapt=true); this one has no adapter to feed"
            )
        future = self._submit(window, resolutions, deadline_s, block_s, tenant=None)
        if label is not None:
            try:
                self.lifecycle.feedback(window, resolutions, label)
            except batcher_mod.ServiceClosedError:
                # stop() closed the adapter after this request was
                # admitted: its answer is still owed, the label is dropped
                pass
        return future

    def feedback(self, window: np.ndarray, resolutions: np.ndarray, label: float) -> bool:
        """One labeled served outcome for the lifecycle manager. True
        when queued for the adapter, False when dropped (counted);
        raises :class:`ServiceClosedError` once the service is draining
        or stopped."""
        if self.lifecycle is None:
            raise ValueError(
                "feedback() needs a lifecycle-enabled service "
                "(adapt=true); this one has no adapter to feed"
            )
        if not self._accepting:
            raise batcher_mod.ServiceClosedError(
                "service is not accepting feedback (draining or stopped)"
            )
        return self.lifecycle.feedback(window, resolutions, label)

    def _submit(self, window, resolutions, deadline_s, block_s, tenant):
        """Admit one request owned by ``tenant`` (None for a
        single-model service); see :meth:`submit`."""
        self.batcher.count("submitted")
        self.batcher._count_tenant(tenant, "submitted")
        if not self._accepting:
            self.batcher.count("rejected_closed")
            raise batcher_mod.ServiceClosedError(
                "service is not accepting requests (draining or stopped)"
            )
        if self.batcher.wedged.is_set():
            self.batcher.count("rejected_wedged")
            raise batcher_mod.ServiceWedgedError(
                "service wedged (watchdog tripped); restart the service"
            )
        req = batcher_mod.Request(
            window=np.asarray(window),
            resolutions=np.asarray(resolutions, np.float32),
            deadline=deadline_mod.Deadline(
                deadline_s if deadline_s is not None
                else self.config.default_deadline_s
            ),
            tenant=tenant,
        )
        if not self.batcher.queue.offer(req, block_s=block_s):
            self.batcher.count("shed")
            self.batcher._count_tenant(tenant, "shed")
            details = self.batcher.queue.last_shed_details
            if tenant is not None:
                details.setdefault("tenant", tenant)
            raise batcher_mod.ShedError(
                f"request shed by admission control: "
                f"{self.batcher.queue.last_shed_evidence}",
                evidence=details,
            )
        if not self._accepting:
            # stop() may have swept the queue between the accepting
            # check above and this offer landing — fail the future now
            # (a no-op if the drain actually served it)
            if req.future.fail(batcher_mod.ServiceClosedError(
                "service stopped while the request was being admitted"
            )):
                self.batcher.count("rejected_closed")
        return req.future

    def _result_timeout(self, budget: float) -> float:
        """Caller-side wait bound: the watchdog guarantees resolution;
        the slack only bounds the pathological late-detected wedge."""
        return budget + self.config.watchdog_s + 5.0

    def predict_window(
        self,
        window: np.ndarray,
        resolutions: np.ndarray,
        deadline_s: Optional[float] = None,
    ) -> batcher_mod.Result:
        """Blocking convenience: submit + wait within the deadline."""
        budget = (
            deadline_s if deadline_s is not None
            else self.config.default_deadline_s
        )
        fut = self.submit(window, resolutions, deadline_s=budget)
        return fut.result(timeout=self._result_timeout(budget))

    def predict_all(
        self,
        windows: Sequence[np.ndarray],
        resolutions,
        deadline_s: Optional[float] = None,
    ) -> List[batcher_mod.Result]:
        """Drive a whole epoch set through the service with submitter-
        side backpressure (blocking admission), collecting results in
        input order — what the ``serve=`` pipeline mode runs.

        ``resolutions`` is either one ``(n_channels,)`` vector shared
        by every window, or a per-window sequence of them (the
        batcher's coalescing key keeps each micro-batch homogeneous).
        """
        return self._predict_all(windows, resolutions, [None] * len(windows), deadline_s)

    def _predict_all(self, windows, resolutions, tenants, deadline_s):
        """:meth:`predict_all` with one owning tenant per window."""
        budget = (
            deadline_s if deadline_s is not None
            else self.config.default_deadline_s
        )
        res_arr = np.asarray(resolutions, dtype=np.float32)
        per_window = res_arr.ndim == 2
        if per_window and len(res_arr) != len(windows):
            raise ValueError(
                f"{len(res_arr)} resolution vectors for {len(windows)} windows"
            )
        futures = [
            self._submit(
                w, res_arr[i] if per_window else res_arr,
                budget, budget, tenants[i],
            )
            for i, w in enumerate(windows)
        ]
        timeout = self._result_timeout(budget)
        return [f.result(timeout=timeout) for f in futures]

    # -- observability --------------------------------------------------

    def stats_block(self) -> dict:
        """The ``serve`` block of a run; safe to call on a live service
        (snapshot under the batcher lock)."""
        counters, lat = self.batcher.snapshot()
        lat.sort()
        return {
            "mode": self.engine.mode,
            "rung": self.engine.rung,
            # a non-f32 engine's warmup gate decision; None at f32
            "precision": self.engine.precision_record,
            "mega": self.engine.mega_record,
            "max_batch": self.config.max_batch,
            "queue_depth": self.config.queue_depth,
            "flush_us": self.config.flush_us,
            "requests": {
                "submitted": counters.get("submitted", 0),
                "completed": counters.get("completed", 0),
                "shed": counters.get("shed", 0),
                "deadline_exceeded": counters.get("deadline_exceeded", 0),
                "failed": counters.get("failed", 0),
                "retries": counters.get("retries", 0),
                "rejected_closed": counters.get("rejected_closed", 0),
                "rejected_wedged": counters.get("rejected_wedged", 0),
            },
            "batches": counters.get("batches", 0),
            "batch_failures": counters.get("batch_failures", 0),
            "mean_batch_size": round(
                counters.get("completed", 0)
                / max(1, counters.get("batches", 0)), 3
            ),
            "latency_ms": {
                "p50": round(_percentile(lat, 50.0) * 1e3, 3),
                "p99": round(_percentile(lat, 99.0) * 1e3, 3),
                "max": round((lat[-1] if lat else 0.0) * 1e3, 3),
                "n": len(lat),
            },
            "watchdog_trips": counters.get("watchdog_trips", 0),
            "wedged": self.batcher.wedged.is_set(),
            "drained_cleanly": self._drained_cleanly,
            "slo": metrics_export.slo_block(
                self.batcher.histogram_snapshot(),
                {
                    "completed": counters.get("completed", 0),
                    "shed": counters.get("shed", 0),
                    "failed": counters.get("failed", 0),
                    "deadline_exceeded": counters.get("deadline_exceeded", 0),
                },
                objective_ms=self.config.slo_latency_ms,
                availability_target=self.config.slo_availability_target,
            ),
            # the lifecycle manager's block; None without one
            "lifecycle": None if self.lifecycle is None else self.lifecycle.block(),
        }
