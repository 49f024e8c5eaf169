"""``execute_plan``: one run, executed in its own fault domain.

Port of the per-run bracket of the JAX package's
``scheduler/runtime.py`` (``execute_plan`` and ``_run_in_domain``), over
the builder's query map (the JAX package's ``ExecutionPlan`` IR and its
multi-plan executor are not ported). Around
``PipelineBuilder._execute`` it

- resolves the fault plan: ``faults=`` (seeded by ``faults_seed=``), or
  ``EEG_TPU_FAULTS`` when the query has none;
- resolves the report directory (``report=``, ``EEG_TPU_RUN_REPORT_DIR``;
  ``obs/report.resolve_report_dir``) and opens the run's telemetry;
- activates a :class:`~..obs.domain.RunDomain` carrying the fault plan
  and the span recorder, with a per-run ``obs.Metrics`` scope;
- fires ``scheduler.plan`` (one run attempt);
- runs the body under ``obs.trace(trace_path)`` when ``trace_path=`` is
  given;
- writes ``crash_report.json`` inside the domain when the run raises
  (so it carries the fault plan's counts), then re-raises; on success
  writes ``run_report.json``. A report write failure is logged and never
  fails the run it observed.
"""

from __future__ import annotations

import logging
import time
from typing import Dict

from .. import obs
from ..obs import chaos, domain as run_domain
from ..obs import report as run_report

logger = logging.getLogger(__name__)


def resolve_fault_plan(query_map: Dict[str, str]):
    """The run's :class:`~..obs.chaos.FaultPlan` from ``faults=`` (or
    ``EEG_TPU_FAULTS``) and ``faults_seed=``; None without a spec."""
    spec = query_map.get("faults") or chaos.plan_from_env()
    if not spec:
        return None
    return chaos.parse_fault_spec(spec, seed=int(query_map.get("faults_seed", 0) or 0))


def execute_plan(query: str, query_map: Dict[str, str], builder):
    """Run ``builder._execute(query_map)`` inside a fresh fault domain;
    returns its statistics and leaves ``builder.telemetry``,
    ``builder.run_metrics`` and ``builder.stage_timer`` set for the run."""
    logger.info("query: %s", query_map)
    fault_plan = resolve_fault_plan(query_map)
    builder.telemetry = None
    builder.stage_timer = obs.StageTimer()
    report_dir = run_report.resolve_report_dir(query_map)
    if report_dir:
        try:
            builder.telemetry = run_report.RunTelemetry(query, query_map, report_dir,
                                                        builder.device)
        except OSError as e:
            logger.warning("run telemetry unavailable (%s: %s); running unreported",
                           type(e).__name__, e)
    telemetry = builder.telemetry
    domain = run_domain.RunDomain(
        chaos=fault_plan, recorder=None if telemetry is None else telemetry.recorder)
    trace_path = query_map.get("trace_path") or None
    start = time.perf_counter()
    with obs.metrics.scope() as run_metrics, run_domain.activate(domain):
        builder.run_metrics = run_metrics
        try:
            # one run attempt (fires when the plan has a scheduler.plan rule)
            chaos.maybe_fire("scheduler.plan")
            if trace_path:
                with obs.trace(trace_path):
                    statistics = builder._execute(query_map)
            else:
                statistics = builder._execute(query_map)
        except Exception as e:
            if telemetry is not None:
                _note_blocks(builder, telemetry)
                telemetry.dump_crash(e, builder.stage_timer, run_metrics)
            raise
        if telemetry is not None:
            _note_blocks(builder, telemetry)
            try:
                telemetry.write_report(statistics, builder.stage_timer, run_metrics,
                                       wall_s=time.perf_counter() - start)
            except OSError as e:
                logger.error("run report write failed: %s", e)
    return statistics


def _note_blocks(builder, telemetry) -> None:
    """The builder's per-run records into the report's blocks; the
    serve block's lifecycle record is the report's own ``lifecycle``."""
    telemetry.backend = dict(builder.backend_resolved or {})
    telemetry.precision = builder.precision_resolved
    telemetry.overlap = builder.overlap_resolved
    telemetry.mesh = builder.mesh_resolved
    telemetry.population = builder.population_block
    telemetry.workload = builder.workload_block
    serve = builder.serve_block
    if serve is not None:
        serve = dict(serve)
        telemetry.lifecycle = serve.pop("lifecycle", None)
    telemetry.serve = serve
