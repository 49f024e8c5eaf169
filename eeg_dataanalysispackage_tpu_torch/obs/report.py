"""Per-run report artifacts and the failure flight recorder.

Port of the JAX package's ``obs/report.py``. One run under
``report=<dir>`` (or ``EEG_TPU_RUN_REPORT_DIR``) writes one atomic
``run_report.json``: the query and the environment knobs set, the
device (platform, count, the card's name), the fused backend, the
precision decision, the mesh (``devices=``/``mesh_axes=``, and a pod's
record: ``processes=``/``coordinator=``/``process_id=``), the
population, serving, lifecycle and workload blocks, the stage timers,
the run's metrics, the span summary (its spans also go to
``spans.jsonl``), the feature and plan caches' counters, the fault plan's per-rule calls and firings, and the
statistics' sha256, accuracy and extended classification block.

When the run raises instead, the same telemetry writes
``crash_report.json``: the error with its traceback, the recent-event
ring, the metrics and the fault plan with its counts. Schemas:
``eeg-tpu-run-report/v1`` and ``eeg-tpu-crash-report/v1``, the JAX
package's; ``tools/obs_report.py show`` renders either package's.

A plan run by the executor (``scheduler/executor.py``) carries its
``plan_id`` and the ``gateway``, ``fleet`` and ``trace`` attribution its
submission passed (``trace.segment`` is None: the port has no trace
sink), its ``dedup`` block the prefix-dedup attribution
(``scheduler/dedup.py``: leader or follower, the prefix key, the rows and
the seconds and bytes saved; None when the run claimed no prefix), and a
crash report's ``fleet_context`` names the replica, the leased devices,
the leases the process held (those of the lease directory the fleet
replica registered, ``scheduler/lease.active_held``) and the process's
lease counters. Keys for machinery the port does not have keep the JAX
package's names: ``caches.compile_cache_dir`` is None, ``degradation`` is empty (the
port has no degradation ladder), and ``xla`` is the JAX package's
compilation block as it reads without a compiler to monitor
(``available`` False, no counts).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import platform
import traceback
from typing import Any, Dict, Optional

from . import events

logger = logging.getLogger(__name__)

#: enables telemetry for every run in the process (a ``report=`` query
#: parameter overrides per run; ``report=false`` opts one run out)
ENV_REPORT_DIR = "EEG_TPU_RUN_REPORT_DIR"

RUN_SCHEMA = "eeg-tpu-run-report/v1"
CRASH_SCHEMA = "eeg-tpu-crash-report/v1"

#: env knobs echoed into the report when set (the JAX package's list)
_ENV_KNOBS = (
    "EEG_TPU_INGEST_WORKERS",
    "EEG_TPU_PREFETCH_DEPTH",
    "EEG_TPU_FEATURE_CACHE_DIR",
    "EEG_TPU_NO_FEATURE_CACHE",
    "EEG_TPU_COMPILE_CACHE_DIR",
    "EEG_TPU_NO_COMPILE_CACHE",
    "EEG_TPU_PLAN_CACHE_FILE",
    "EEG_TPU_CIRCUIT_THRESHOLD",
    "EEG_TPU_CIRCUIT_COOLDOWN",
    "EEG_TPU_FAULTS",
    "EEG_TPU_RUN_REPORT_DIR",
    "EEG_TPU_TRACE_DIR",
    "EEG_TPU_OVERLAP",
    "EEG_TPU_PRECISION",
    "EEG_TPU_BF16_GATE_TOL",
    "EEG_TPU_INT8_GATE_TOL",
    "EEG_TPU_MEGA_GATE_TOL",
    "EEG_TPU_SERVE_FLUSH_US",
    "EEG_TPU_DECODE_FORMULATION",
    "EEG_PALLAS_MODE",
    "JAX_PLATFORMS",
)

#: the JAX package's compilation block with nothing to monitor: the
#: port compiles its CUDA kernels with nvcc, outside any run
_NO_XLA = {"available": False, "compilations": None, "backend_compile_s": None,
           "phases": {}}


def resolve_report_dir(query_map: Dict[str, str]) -> Optional[str]:
    """Where this run's report artifacts go, or None (telemetry off).

    ``report=<dir>`` wins; ``report=true`` writes next to
    ``result_path`` (its directory, else the cwd); ``report=false``
    opts out even when ``EEG_TPU_RUN_REPORT_DIR`` is set; otherwise the
    env var decides.
    """
    value = query_map.get("report", "")
    if value == "false":
        return None
    if value and value != "true":
        return value
    if value == "true":
        result_path = query_map.get("result_path", "")
        return os.path.dirname(result_path) or "."
    return os.environ.get(ENV_REPORT_DIR) or None


def device_block(device) -> Dict[str, Any]:
    """The run's device: ``platform`` ``gpu`` or ``cpu``, the count of
    that kind, and its name (the card's, or the host processor's)."""
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "device_count": torch.cuda.device_count(),
                "name": torch.cuda.get_device_name(device)}
    return {"platform": "cpu", "device_count": 1, "name": platform.processor() or "cpu"}


class RunTelemetry:
    """Everything one reported run carries: the span recorder (with a
    JSONL sink beside the report) and the blocks the run bracket fills
    from the builder. Made only when a run opted in."""

    def __init__(self, query: str, query_map: Dict[str, str], directory: str, device):
        self.query = query
        self.query_map = dict(query_map)
        self.directory = directory
        self.device = device
        os.makedirs(directory, exist_ok=True)
        self.recorder = events.SpanRecorder(
            name="run", jsonl_path=os.path.join(directory, "spans.jsonl"))
        #: {"requested", "landed"} of a fused run; {} otherwise
        self.backend: Dict[str, Any] = {}
        self.population: Optional[Dict[str, Any]] = None
        self.serve: Optional[Dict[str, Any]] = None
        self.lifecycle: Optional[Dict[str, Any]] = None
        self.workload: Optional[Dict[str, Any]] = None
        self.precision: Optional[Dict[str, Any]] = None
        #: whether the fused ingest overlapped (``overlap=``); None when
        #: the run never reached the fused ingest
        self.overlap: Optional[bool] = None
        #: the run's mesh record (``requested``, ``rung``, ``shape``,
        #: ``devices``, the population's; on a pod ``rung: "pod"`` with
        #: ``processes``, ``process_id``, ``coordinator``, ``dcn_shape``
        #: and ``backend``; a ``pod`` block for ``processes=1`` or a
        #: bootstrap that failed, with its evidence), None without
        #: ``devices=``, ``mesh_axes=`` or the pod keys
        self.mesh: Optional[Dict[str, Any]] = None
        #: the executor's plan id, and the submission's attribution:
        #: networked (``{"via", "idempotency_key", "client"}``), replica
        #: (``{"replica", "takeover"}``) and the distributed trace id
        self.plan_id: Optional[str] = None
        #: the run's prefix-dedup attribution (``scheduler/dedup.py``)
        self.dedup: Optional[Dict[str, Any]] = None
        self.gateway: Optional[Dict[str, Any]] = None
        self.fleet: Optional[Dict[str, Any]] = None
        self.trace_id: Optional[str] = None

    @property
    def report_path(self) -> str:
        return os.path.join(self.directory, "run_report.json")

    @property
    def crash_path(self) -> str:
        return os.path.join(self.directory, "crash_report.json")

    def _common(self, timers, metrics) -> Dict[str, Any]:
        from ..io import circuit, feature_cache
        from ..ops import plan_cache
        from . import chaos

        plan = chaos.active_plan()
        pstats = plan_cache.stats()
        return {
            "query": self.query,
            "query_map": self.query_map,
            "plan_id": self.plan_id,
            "circuit": circuit.snapshot(),
            "env": {k: os.environ[k] for k in _ENV_KNOBS if k in os.environ},
            "device": device_block(self.device),
            "backend": dict(self.backend),
            "population": self.population,
            "serve": self.serve,
            "lifecycle": self.lifecycle,
            "workload": self.workload,
            "precision": self.precision,
            "overlap": self.overlap,
            "mesh": self.mesh,
            "dedup": self.dedup,
            "gateway": self.gateway,
            "fleet": self.fleet,
            "trace": None if self.trace_id is None else {"trace_id": self.trace_id,
                                                         "segment": None},
            "degradation": [],
            "stages": timers.as_dict() if timers is not None else {},
            "metrics": metrics.snapshot() if metrics is not None else {},
            "caches": {
                "feature_cache": feature_cache.stats(),
                "plan_cache": {"hits": pstats["hits"], "misses": pstats["misses"]},
                "compile_cache_dir": None,
            },
            "xla": dict(_NO_XLA),
            "chaos": None if plan is None else {
                "spec": plan.spec,
                "seed": plan.seed,
                "rules": {point: {"calls": rule.calls, "fired": rule.fired}
                          for point, rule in plan.rules.items()},
            },
        }

    def write_report(self, statistics, timers, metrics, wall_s: float) -> str:
        """The success artifact: one atomic ``run_report.json``; a stale
        crash report in the directory is removed."""
        self.recorder.finish()
        payload = {
            "schema": RUN_SCHEMA,
            "outcome": "ok",
            "wall_s": round(wall_s, 6),
            **self._common(timers, metrics),
            "spans": self.recorder.summary(),
            "statistics_sha256": hashlib.sha256(str(statistics).encode()).hexdigest(),
            "accuracy": _accuracy_of(statistics),
            "classification": _classification_of(statistics),
        }
        _atomic_json(self.report_path, payload)
        try:
            os.unlink(self.crash_path)
        except OSError:
            pass
        logger.info("run report written: %s", self.report_path)
        return self.report_path

    def _fleet_context(self) -> Optional[Dict[str, Any]]:
        """The replica and the process's lease state for a plan that
        died on a fleet replica; None outside a fleet."""
        if not self.fleet:
            return None
        try:
            from ..scheduler import lease

            return {
                "replica": self.fleet.get("replica"),
                "takeover": bool(self.fleet.get("takeover")),
                "devices": self.fleet.get("devices"),
                "held_leases": lease.active_held(),
                "lease_counters": lease.stats(),
            }
        except Exception:  # the dump must never mask the real error
            return {"replica": self.fleet.get("replica")}

    def dump_crash(self, error: BaseException, timers, metrics) -> str:
        """The failure artifact: the error, the flight-recorder ring and
        the run's state; a stale run report in the directory is
        removed. A write failure is logged and never masks ``error``."""
        self.recorder.finish()
        payload = {
            "schema": CRASH_SCHEMA,
            "outcome": "error",
            "error": {
                "type": type(error).__name__,
                "message": str(error),
                "traceback": traceback.format_exception(type(error), error,
                                                        error.__traceback__),
            },
            **self._common(timers, metrics),
            "spans": self.recorder.summary(),
            "events": self.recorder.recent_events(),
            "fleet_context": self._fleet_context(),
        }
        try:
            _atomic_json(self.crash_path, payload)
            try:
                os.unlink(self.report_path)
            except OSError:
                pass
        except OSError as e:
            logger.error("crash report write failed: %s", e)
            return ""
        logger.error("crash report written: %s (%s: %s)", self.crash_path,
                     type(error).__name__, error)
        return self.crash_path


def _classification_of(statistics) -> Any:
    """The extended imbalanced-class block (``extended_summary``) of a
    seizure run; per member for dict-shaped statistics; None for a plain
    report."""
    try:
        if hasattr(statistics, "items") and not hasattr(statistics, "extended_report"):
            members = {name: _classification_of(s) for name, s in statistics.items()}
            if any(v is not None for v in members.values()):
                return members
            return None
        if getattr(statistics, "extended_report", False):
            summary = statistics.extended_summary()
            return {k: (round(v, 6) if isinstance(v, float) else v) for k, v in summary.items()}
        return None
    except Exception:
        return None


def _accuracy_of(statistics) -> Any:
    """Per-classifier accuracy for fan-out results, a scalar otherwise
    (None if the statistics have none)."""
    try:
        if hasattr(statistics, "items") and not hasattr(statistics, "calc_accuracy"):
            return {name: round(s.calc_accuracy(), 6) for name, s in statistics.items()}
        return round(statistics.calc_accuracy(), 6)
    except Exception:
        return None


def _atomic_json(path: str, payload: Dict[str, Any]) -> None:
    from ..io.modelfiles import atomic_write_bytes

    atomic_write_bytes(
        path, (json.dumps(payload, indent=2, sort_keys=True, default=str) + "\n").encode())
