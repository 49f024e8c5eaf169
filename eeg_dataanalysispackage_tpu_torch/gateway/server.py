"""The gateway's HTTP server over the port's :class:`~..scheduler.PlanExecutor`.

Port of the JAX package's ``gateway/server.py``, to its wire contract. The
gateway adds a wire format, never semantics: admission is the executor's
shed-with-evidence queue, deadlines its per-plan budgets, idempotency rides
the write-ahead journal, recovery is ``recover()`` at start. It holds no
state the journal does not (with a journal): kill it mid-plan, restart it
over the same ``journal_dir``, and ``recover()`` resumes every unfinished
plan under its original id. Stdlib ``ThreadingHTTPServer``; no request
handler does device work (a submit returns once the plan is journaled and
queued).

Wire contract (JSON but ``/metrics``):

====== ========================== ===========================================
method path                       outcome
====== ========================== ===========================================
POST   /plans                     201 {plan_id, state, idempotent_replay,
                                  trace_id}; the body is the query string,
                                  percent-escapes decoded
                                  (``pipeline.builder.decode_percent_query``);
                                  200 when ``X-Idempotency-Key`` replayed an
                                  existing plan; 400 invalid; 409 a key
                                  reused with another body; 429 shed (with
                                  evidence and the journaled plan id); 503
                                  closed or draining
POST   /predict                   the serving hot path over an attached
                                  ``predict_service`` (a
                                  ``serve.MultiplexedService``: the tenant
                                  stack, K6 on the card): body {tenant,
                                  window, resolutions[, deadline_s]}; 200
                                  {tenant, prediction, margin, latency_ms,
                                  batch_size, attempts, idempotent_replay,
                                  trace_id}; a replayed
                                  ``X-Idempotency-Key`` returns the cached
                                  answer, 409 with another body; 400
                                  invalid or unknown tenant; 429 shed with
                                  the tenant's evidence; 503 no service,
                                  closed or wedged; 504 admitted but not
                                  answered in budget
GET    /plans                     200 {plans: [...]}: journal and live states
GET    /plans/<id>                200 status; 404 unknown
GET    /plans/<id>/report         200 {statistics, statistics_sha256, error,
                                  run_report}; 409 while not terminal
DELETE /plans/<id>                200 {cancelled: true}; 409 not queued
GET    /stats                     200 {dedup, queue_depth, scheduler}; with a
                                  ``predict_service`` also ``serve`` (its
                                  ``stats_block()``); with leases (a fleet
                                  replica) also ``fleet``
GET    /metrics                   200 Prometheus text
                                  (``obs/metrics_export.render``): every
                                  ``obs.metrics`` counter and gauge, the
                                  serve latency histograms, the lease
                                  counters, queue depth, the device pool's
                                  gauges, and ``eeg_tpu_build_info`` naming
                                  the replica
GET    /healthz                   200 {ok: true, ...}: liveness, no disk
GET    /readyz                    200 {ready: true} only when the journal
                                  directory is writable, the executor
                                  accepts, the replica is not draining and
                                  the device pool is not exhausted; else 503
                                  {ready: false, reasons}
====== ========================== ===========================================

Headers on ``POST /plans``: ``X-Idempotency-Key`` (journaled with the plan
record), ``X-Plan-Deadline-S`` (float; the plan's deadline budget),
``X-Trace-Id`` (the caller's trace id, minted by :func:`mint_trace_id` when
absent or malformed, echoed and journaled so a fleet takeover continues it).
``X-Trace-Id`` is honoured on ``POST /predict`` too.

The gateway runs its plans on ``device`` (``None``: ``cuda``, which raises
without a card), the device of the executor it builds.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .. import obs
from ..obs import metrics_export
from ..scheduler import dedup as dedup_mod, lease as lease_mod
from ..scheduler.executor import (
    IdempotencyConflictError,
    PlanExecutor,
    PlanOwnedElsewhereError,
    PlanShedError,
)
from ..serve.batcher import ServeError, ServiceClosedError, ServiceWedgedError, ShedError

logger = logging.getLogger(__name__)

#: bound on the /predict idempotency replay cache
_PREDICT_CACHE_LIMIT = 4096

#: default port when none is given (0 = ephemeral, the test default)
ENV_PORT = "EEG_TPU_GATEWAY_PORT"

_PLAN_PATH = re.compile(r"^/plans/([A-Za-z0-9_.-]+)(/report)?$")

#: an acceptable inbound X-Trace-Id (file-name safe); anything else is
#: ignored and a fresh id minted
_TRACE_ID = re.compile(r"^[A-Za-z0-9_.-]{1,128}$")


def mint_trace_id(inbound: Optional[str] = None) -> str:
    """The request's trace id: the caller's ``X-Trace-Id`` when it is
    well-formed, a fresh uuid4 hex otherwise."""
    if inbound and _TRACE_ID.match(inbound):
        return inbound
    return uuid.uuid4().hex


def _sha256(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


class GatewayServer:
    """One HTTP front door over one :class:`PlanExecutor`.

    Pass an ``executor`` to front an existing one, or let the gateway own a
    fresh executor on ``device`` built from the keyword knobs (closed with
    the gateway). ``recover=True`` replays the journal at :meth:`start`."""

    def __init__(
        self,
        executor: Optional[PlanExecutor] = None,
        host: str = "127.0.0.1",
        port: Optional[int] = None,
        journal_dir: Optional[str] = None,
        report_root: Optional[str] = None,
        max_concurrent: int = 2,
        queue_depth: int = 16,
        max_attempts: int = 3,
        recover: bool = True,
        predict_service=None,
        replica_id: Optional[str] = None,
        device=None,
    ):
        if port is None:
            port = int(os.environ.get(ENV_PORT, "0") or 0)
        self.host = host
        #: this front door's identity in a fleet (lease files carry it, run
        #: reports echo it)
        self.replica_id = replica_id or f"gw-{os.getpid()}"
        #: True while a SIGTERM drain runs: submissions answer 503, /readyz
        #: is not ready, plans in flight run to completion
        self.draining = False
        self._requested_port = int(port)
        self._owns_executor = executor is None
        self.executor = executor or PlanExecutor(
            max_concurrent=max_concurrent, queue_depth=queue_depth, journal_dir=journal_dir,
            report_root=report_root, max_attempts=max_attempts, name="gateway", device=device,
        )
        self._recover = recover
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        #: plan_id -> PlanHandle, kept only without a journal (the handle is
        #: then the only route to a finished plan's statistics)
        self._handles: Dict[str, Any] = {}
        self.recovery: Optional[Dict[str, Any]] = None
        #: the /predict back end (a ``serve.MultiplexedService``), attached
        #: by the operator and not owned: its start and stop stay with whoever
        #: built it. None: POST /predict answers 503
        self.predict_service = predict_service
        #: /predict replay cache: key -> (body sha, status, payload); only
        #: answered requests are cached, so a shed stays retryable
        self._predict_cache: Dict[str, Tuple[str, int, Dict[str, Any]]] = {}
        self._predict_cache_lock = threading.Lock()

    # -- lifecycle

    def start(self) -> Tuple[str, int]:
        """Start the executor, recover the journal, bind and serve. Returns
        (host, port), the bound port when 0 was asked for."""
        self.executor.start()
        if self._recover and self.executor.journal is not None:
            self.recovery = self.executor.recover()
        server = self

        class _Handler(_GatewayHandler):
            gateway = server

        self._httpd = ThreadingHTTPServer((self.host, self._requested_port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="eeg-tpu-gateway-http", daemon=True)
        self._thread.start()
        logger.info("gateway serving on %s:%d", self.host, self.port)
        return self.host, self.port

    @property
    def port(self) -> int:
        if self._httpd is None:
            return self._requested_port
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self, join_timeout_s: float = 10.0) -> None:
        """Stop accepting, shut the HTTP loop down and close an owned
        executor (queued journaled plans stay ``submitted`` for the next
        ``recover()``)."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=join_timeout_s)
            self._thread = None
        if self._owns_executor:
            self.executor.close(join_timeout_s=join_timeout_s)

    def __enter__(self) -> "GatewayServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the endpoint bodies (HTTP-free, testable directly)

    def submit_query(self, raw_body: str, deadline_s: Optional[float] = None,
                     idempotency_key: Optional[str] = None, client: Optional[str] = None,
                     trace_id: Optional[str] = None) -> Tuple[int, Dict[str, Any]]:
        from ..pipeline.builder import decode_percent_query

        trace_id = mint_trace_id(trace_id)
        if self.draining:
            return 503, {"error": f"replica {self.replica_id} is draining; submit to a peer",
                         "draining": True, "replica": self.replica_id}
        try:
            query = decode_percent_query(raw_body.strip())
        except ValueError as e:
            return 400, {"error": str(e)}
        if not query:
            return 400, {"error": "empty request body; POST the query string"}
        gateway_block = {"via": "http", "replica": self.replica_id}
        if idempotency_key:
            gateway_block["idempotency_key"] = idempotency_key
        if client:
            gateway_block["client"] = client
        try:
            handle = self.executor.submit(query, deadline_s=deadline_s,
                                          idempotency_key=idempotency_key,
                                          gateway=gateway_block, trace_id=trace_id)
        except PlanShedError as e:
            # backpressure, with the evidence and the journaled id; the key
            # was not bound
            return 429, {"error": str(e), "shed": True, "plan_id": e.plan_id}
        except ServiceClosedError as e:
            return 503, {"error": str(e)}
        except IdempotencyConflictError as e:
            return 409, {"error": str(e), "idempotency_conflict": True}
        except PlanOwnedElsewhereError as e:
            # a keyed re-submit of a plan a live peer runs: the original id
            # is the answer, with the owner
            status = self.executor.status(e.plan_id) or {}
            return 200, {"plan_id": e.plan_id, "state": status.get("state", "submitted"),
                         "idempotent_replay": True, "owner": e.holder,
                         "replica": self.replica_id,
                         "trace_id": self._journaled_trace_id(e.plan_id) or trace_id}
        except ValueError as e:
            return 400, {"error": str(e)}
        replayed = bool(getattr(handle, "replayed", False))
        if not replayed and self.executor.journal is None:
            with self._lock:
                self._handles[handle.plan_id] = handle
        if replayed:
            # a keyed replay continues the original submission's trace
            trace_id = self._journaled_trace_id(handle.plan_id) or trace_id
        return (200 if replayed else 201), {"plan_id": handle.plan_id, "state": handle.state,
                                            "idempotent_replay": replayed,
                                            "trace_id": trace_id}

    def _journaled_trace_id(self, plan_id: str) -> Optional[str]:
        journal = self.executor.journal
        entry = journal.entry(plan_id) if journal is not None else None
        if entry is None:
            return None
        return (entry.get("meta") or {}).get("trace_id")

    def predict_payload(self, raw_body: str, idempotency_key: Optional[str] = None,
                        trace_id: Optional[str] = None) -> Tuple[int, Dict[str, Any]]:
        """One tenant-keyed prediction against the attached service. Body:
        ``{"tenant": str, "window": [[...]] (int16 samples, channels x
        window), "resolutions": [...], "deadline_s": float?}``."""
        trace_id = mint_trace_id(trace_id)
        if self.predict_service is None:
            return 503, {"error": "no prediction service attached to this gateway "
                                  "(predict_service=)"}
        body_sha = _sha256(raw_body)
        if idempotency_key:
            with self._predict_cache_lock:
                cached = self._predict_cache.get(idempotency_key)
            if cached is not None:
                prior_sha, code, payload = cached
                if prior_sha != body_sha:
                    return 409, {"error": f"idempotency key {idempotency_key!r} was already "
                                          f"used with a different request body",
                                 "idempotency_conflict": True}
                return code, dict(payload, idempotent_replay=True)
        try:
            request = json.loads(raw_body)
        except ValueError as e:
            return 400, {"error": f"request body is not JSON: {e}"}
        if not isinstance(request, dict):
            return 400, {"error": "request body must be a JSON object"}
        tenant = request.get("tenant")
        if not isinstance(tenant, str) or not tenant:
            return 400, {"error": "tenant must be a non-empty string"}
        deadline_s = request.get("deadline_s")
        if deadline_s is not None and not isinstance(deadline_s, (int, float)):
            return 400, {"error": "deadline_s must be a number"}
        try:
            window = np.asarray(request["window"], dtype=np.int16)
            resolutions = np.asarray(request["resolutions"], dtype=np.float32)
        except KeyError as e:
            return 400, {"error": f"missing field {e.args[0]!r}"}
        except (TypeError, ValueError) as e:
            return 400, {"error": f"malformed window/resolutions: {e}"}
        try:
            result = self.predict_service.predict_window(window, resolutions, tenant=tenant,
                                                         deadline_s=deadline_s)
        except ShedError as e:
            # the tenant's backpressure with the queue's evidence; not cached
            return 429, {"error": str(e), "shed": True, "tenant": tenant,
                         "evidence": e.evidence}
        except (ServiceClosedError, ServiceWedgedError) as e:
            return 503, {"error": str(e), "tenant": tenant}
        except ValueError as e:
            # an unknown tenant or a wrong window: the request is the bug
            return 400, {"error": str(e), "tenant": tenant}
        except ServeError as e:
            # admitted, not answered in budget (deadline, retries spent)
            return 504, {"error": str(e), "tenant": tenant, "failed": True}
        payload = {
            "tenant": tenant,
            "prediction": float(result.prediction),
            "margin": None if result.margin is None else float(result.margin),
            "latency_ms": round(result.latency_s * 1e3, 3),
            "batch_size": result.batch_size,
            "attempts": result.attempts,
            "idempotent_replay": False,
            "trace_id": trace_id,
        }
        if idempotency_key:
            with self._predict_cache_lock:
                if len(self._predict_cache) >= _PREDICT_CACHE_LIMIT:
                    self._predict_cache.pop(next(iter(self._predict_cache)))
                self._predict_cache[idempotency_key] = (body_sha, 200, payload)
        return 200, payload

    def _lease_owner(self, plan_id: str) -> Optional[str]:
        """The lease-holding replica's id when it is not this one."""
        leases = self.executor.leases
        if leases is None:
            return None
        info = leases.holder_info(plan_id)
        if info is None or info["holder"] == self.replica_id:
            return None
        return info["holder"]

    def status_payload(self, plan_id: str) -> Tuple[int, Dict[str, Any]]:
        status = self.executor.status(plan_id)
        if status is None:
            return 404, {"error": f"unknown plan {plan_id}"}
        owner = self._lease_owner(plan_id)
        if owner is not None:
            status = dict(status, owner=owner)
        return 200, status

    def report_payload(self, plan_id: str) -> Tuple[int, Dict[str, Any]]:
        """A finished plan's statistics text (the journal's, else the live
        handle's), its terminal error, and its ``run_report.json``."""
        status = self.executor.status(plan_id)
        if status is None:
            return 404, {"error": f"unknown plan {plan_id}"}
        if status["state"] not in ("completed", "failed", "cancelled"):
            return 409, {"error": f"plan {plan_id} is {status['state']}; not terminal yet",
                         "state": status["state"]}
        payload: Dict[str, Any] = {
            "plan_id": plan_id,
            "state": status["state"],
            "attempts": status.get("attempts", 0),
            "statistics": None,
            "statistics_sha256": status.get("statistics_sha256"),
            "error": status.get("error"),
            "run_report": None,
        }
        journal = self.executor.journal
        entry = journal.entry(plan_id) if journal is not None else None
        if entry is not None:
            payload["statistics"] = entry.get("statistics")
            payload["statistics_sha256"] = entry.get("statistics_sha256")
            payload["error"] = entry.get("error", payload["error"])
        if payload["statistics"] is None:
            # no journal, or its completion write degraded: the live handle
            handle = self._handles.get(plan_id) or self.executor.handle(plan_id)
            if handle is not None and handle.done:
                try:
                    text = str(handle.result(timeout=0).statistics)
                    payload["statistics"] = text
                    payload["statistics_sha256"] = _sha256(text)
                except Exception as e:
                    payload["error"] = payload["error"] or f"{type(e).__name__}: {e}"
        report_dir = status.get("report_dir")
        if report_dir:
            try:
                with open(os.path.join(report_dir, "run_report.json")) as f:
                    payload["run_report"] = json.load(f)
            except (OSError, ValueError):
                pass
        return 200, payload

    def cancel_payload(self, plan_id: str) -> Tuple[int, Dict[str, Any]]:
        status = self.executor.status(plan_id)
        if status is None:
            return 404, {"error": f"unknown plan {plan_id}"}
        if self.executor.cancel(plan_id):
            return 200, {"plan_id": plan_id, "cancelled": True}
        return 409, {"plan_id": plan_id, "cancelled": False,
                     "state": self.executor.status(plan_id)["state"],
                     "error": "plan is not queued (already running or terminal)"}

    def list_payload(self) -> Tuple[int, Dict[str, Any]]:
        plans: Dict[str, Dict[str, Any]] = {}
        journal = self.executor.journal
        if journal is not None:
            for entry in journal.entries():
                meta = entry.get("meta") or {}
                plans[entry["plan_id"]] = {
                    "plan_id": entry["plan_id"],
                    "state": "cancelled" if meta.get("cancelled") else entry.get("state"),
                    "attempts": int(entry.get("attempts", 0) or 0),
                    "query": entry.get("query", ""),
                }
        # live tickets override journal snapshots (a submitted record whose
        # plan runs shows as running)
        live = set(self.executor.live_ids())
        live.update(self._handles)
        for plan_id in live:
            status = self.executor.status(plan_id)
            if status is not None:
                plans[plan_id] = {k: status.get(k)
                                  for k in ("plan_id", "state", "attempts", "query")}
        # a submitted record a peer lease-holds is in flight over there
        if self.executor.leases is not None:
            for plan_id, row in plans.items():
                owner = self._lease_owner(plan_id)
                if owner is not None:
                    row["owner"] = owner
        return 200, {"plans": [plans[k] for k in sorted(plans)]}

    def stats_payload(self) -> Tuple[int, Dict[str, Any]]:
        counters = obs.metrics.snapshot()["counters"]
        payload = {
            "dedup": dedup_mod.stats(),
            "queue_depth": len(self.executor.queue),
            "scheduler": {k: v for k, v in sorted(counters.items())
                          if k.startswith("scheduler.")},
        }
        if self.predict_service is not None:
            payload["serve"] = self.predict_service.stats_block()
        leases = self.executor.leases
        if leases is not None:
            payload["fleet"] = {
                "replica": self.replica_id,
                "draining": self.draining,
                "held_leases": len(leases.held_plan_leases()),
                "devices_held": leases.held_device_ordinals(),
                **lease_mod.stats(),
            }
            if self.executor.placement is not None:
                payload["fleet"]["device_pool"] = self.executor.placement.health()
        return 200, payload

    def metrics_payload(self) -> Tuple[int, str]:
        """This replica's Prometheus text exposition: the ``obs.metrics``
        counters and gauges, the serve latency histograms (service-wide and
        per tenant), lease counters, queue depth, the device pool's gauges
        and the build-info series naming the replica."""
        snap = obs.metrics.snapshot()
        counters = dict(snap["counters"])
        gauges = dict(snap["gauges"])
        gauges["gateway.queue_depth"] = len(self.executor.queue)
        histograms = []
        if self.predict_service is not None:
            batcher = self.predict_service.batcher
            histograms.append(("serve_request_latency_ms", {}, batcher.histogram_snapshot()))
            for tenant, hist in sorted(batcher.tenant_histogram_snapshot().items()):
                histograms.append(("serve_request_latency_ms", {"tenant": tenant}, hist))
        leases = self.executor.leases
        if leases is not None:
            for key, value in lease_mod.stats().items():
                counters[f"lease.{key}"] = value
            gauges["fleet.held_leases"] = len(leases.held_plan_leases())
            gauges["fleet.devices_held"] = len(leases.held_device_ordinals())
            gauges["fleet.draining"] = int(self.draining)
            if self.executor.placement is not None:
                health = self.executor.placement.health()
                gauges["fleet.devices_free"] = health["free"]
                gauges["fleet.plans_waiting_placement"] = health["waiting"]
        return 200, metrics_export.render(counters=counters, histograms=histograms,
                                          gauges=gauges, info={"replica": self.replica_id})

    def health_payload(self) -> Tuple[int, Dict[str, Any]]:
        """Liveness only: the process answers. Touches no disk (a replica
        with a read-only journal is alive but not ready)."""
        return 200, {"ok": True, "replica": self.replica_id,
                     "queued": len(self.executor.queue),
                     "journal": self.executor.journal is not None}

    def ready_payload(self) -> Tuple[int, Dict[str, Any]]:
        """Readiness: a writable journal directory (the write-ahead record
        and the lease claim land there), an executor started and not
        closed, no drain, and a device pool that is not exhausted while
        plans wait and this replica holds none of it."""
        reasons = []
        journal = self.executor.journal
        if journal is not None:
            probe = os.path.join(journal.directory, f".readyz-{self.replica_id}-{os.getpid()}")
            try:
                fd = os.open(probe, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
                os.unlink(probe)
            except OSError as e:
                reasons.append(f"journal dir {journal.directory} is not writable "
                               f"({type(e).__name__}: {e})")
        if self.draining:
            reasons.append("draining (SIGTERM received)")
        if self.executor._stop.is_set():
            reasons.append("executor is closed")
        elif not self.executor._started:
            reasons.append("executor workers not started")
        placement = self.executor.placement
        if placement is not None:
            try:
                health = placement.health()
            except Exception:  # an observer only
                health = None
            if (health is not None and health["waiting"] > 0 and health["free"] == 0
                    and not health["held"]):
                reasons.append(
                    f"device pool exhausted: 0 of {health['size']} ordinals claimable, "
                    f"none held here, {health['waiting']} plan(s) waiting (oldest: "
                    f"{health['oldest_waiting']})")
        payload = {"ready": not reasons, "replica": self.replica_id,
                   "queued": len(self.executor.queue),
                   "capacity": self.executor.max_concurrent}
        if reasons:
            payload["reasons"] = reasons
            return 503, payload
        return 200, payload


class _GatewayHandler(BaseHTTPRequestHandler):
    """Routes HTTP onto the gateway's endpoint bodies."""

    #: bound by GatewayServer.start()'s subclass
    gateway: GatewayServer = None  # type: ignore[assignment]
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        logger.debug("gateway http: " + fmt, *args)

    def _send_bytes(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send(self, code: int, payload: Dict[str, Any]) -> None:
        self._send_bytes(code, (json.dumps(payload) + "\n").encode(), "application/json")

    def _body(self) -> str:
        length = int(self.headers.get("Content-Length", "0") or 0)
        return self.rfile.read(length).decode("utf-8", "replace")

    def do_POST(self) -> None:
        path = self.path.rstrip("/")
        if path == "/predict":
            self._send(*self.gateway.predict_payload(
                self._body(), idempotency_key=self.headers.get("X-Idempotency-Key"),
                trace_id=self.headers.get("X-Trace-Id")))
            return
        if path != "/plans":
            self._send(404, {"error": f"no such endpoint {self.path}"})
            return
        deadline_s: Optional[float] = None
        raw_deadline = self.headers.get("X-Plan-Deadline-S")
        if raw_deadline:
            try:
                deadline_s = float(raw_deadline)
            except ValueError:
                self._send(400, {"error": f"X-Plan-Deadline-S must be a float, got "
                                          f"{raw_deadline!r}"})
                return
        self._send(*self.gateway.submit_query(
            self._body(), deadline_s=deadline_s,
            idempotency_key=self.headers.get("X-Idempotency-Key"),
            client=self.client_address[0], trace_id=self.headers.get("X-Trace-Id")))

    def do_GET(self) -> None:
        path = self.path.split("?", 1)[0]
        routes = {"/healthz": self.gateway.health_payload,
                  "/readyz": self.gateway.ready_payload,
                  "/stats": self.gateway.stats_payload}
        if path in routes:
            self._send(*routes[path]())
            return
        if path == "/metrics":
            code, text = self.gateway.metrics_payload()
            self._send_bytes(code, text.encode("utf-8"), metrics_export.CONTENT_TYPE)
            return
        if path.rstrip("/") == "/plans":
            self._send(*self.gateway.list_payload())
            return
        match = _PLAN_PATH.match(path)
        if match is None:
            self._send(404, {"error": f"no such endpoint {path}"})
            return
        plan_id, want_report = match.group(1), match.group(2)
        if want_report:
            self._send(*self.gateway.report_payload(plan_id))
        else:
            self._send(*self.gateway.status_payload(plan_id))

    def do_DELETE(self) -> None:
        match = _PLAN_PATH.match(self.path)
        if match is None or match.group(2):
            self._send(404, {"error": f"no such endpoint {self.path}"})
            return
        self._send(*self.gateway.cancel_payload(match.group(1)))
