"""``execute_plan``: one validated plan, executed in its own fault domain.

Port of the JAX package's ``scheduler/runtime.py``. ``PipelineBuilder.execute``
is a shim over ``ExecutionPlan.parse`` and this function, and the executor's
workers (``scheduler/executor.py``) call it for every plan they run, so one
code path serves both. Around ``PipelineBuilder._execute(plan)`` it

- resolves the fault plan: ``faults=`` (seeded by ``faults_seed=``), or
  ``EEG_TPU_FAULTS`` when the query has none, unless the caller passes one
  (the executor resolves it once a submission, so a retried plan keeps one
  set of call counts);
- resolves the report directory: ``report=``, else
  ``EEG_TPU_RUN_REPORT_DIR`` (under the executor, the plan's own
  ``<dir>/<plan_id>``), else the executor's ``default_report_dir``;
  ``report=false`` opts out;
- activates a :class:`~..obs.domain.RunDomain` carrying the plan id, the
  fault plan, the span recorder and the plan's own ``obs.Metrics`` child
  (the builder's ``run_metrics``): counts made on the plan's threads go to
  it and to no other plan's;
- fires ``scheduler.plan`` (one run attempt);
- runs the body under ``obs.trace(trace_path)`` when ``trace_path=`` is
  given;
- writes ``crash_report.json`` inside the domain when the run raises, then
  re-raises; on success writes ``run_report.json``, with the plan id and the
  ``gateway``, ``fleet`` and ``trace_id`` attribution the caller passed. A
  report write failure is logged and never fails the run it observed.

The JAX package's persistent compile cache has no counterpart (the CUDA
kernels are built by ``nvcc`` outside any run), and a ``placement`` grant
raises: device placement (ROADMAP A9.4) is not ported, and a plan never
runs unplaced without telling its caller.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

from .. import obs
from ..obs import chaos, domain as run_domain
from ..obs import report as run_report

logger = logging.getLogger(__name__)

#: "no fault plan was passed: resolve one from the plan or the environment"
_RESOLVE = object()


def resolve_fault_plan(plan):
    """The plan's :class:`~..obs.chaos.FaultPlan` from ``faults=`` (or
    ``EEG_TPU_FAULTS``) and ``faults_seed=``; None without a spec."""
    spec = plan.faults or chaos.plan_from_env()
    return chaos.parse_fault_spec(spec, seed=plan.faults_seed) if spec else None


def execute_plan(
    plan,
    builder,
    plan_id: Optional[str] = None,
    fault_plan=_RESOLVE,
    default_report_dir: Optional[str] = None,
    gateway: Optional[dict] = None,
    fleet: Optional[dict] = None,
    trace_id: Optional[str] = None,
    placement=None,
):
    """Run ``plan`` through ``builder`` inside a fresh fault domain; returns
    its statistics and leaves ``builder.telemetry``, ``builder.run_metrics``
    and ``builder.stage_timer`` set for the run."""
    if placement is not None:
        raise ValueError(
            "placement= grants leased device ordinals (scheduler/placement.py), "
            "which the port does not have yet (ROADMAP A9.4); the plan was not run"
        )
    query_map = plan.query_map
    logger.info("query: %s", query_map)
    if fault_plan is _RESOLVE:
        fault_plan = resolve_fault_plan(plan)
    builder.telemetry = None
    builder.stage_timer = obs.StageTimer()
    report_dir = run_report.resolve_report_dir(query_map)
    if report_dir is not None and plan_id is not None and not query_map.get("report", ""):
        # the environment's directory under an executor: each plan its own
        # subdirectory, or concurrent plans would overwrite one report
        report_dir = os.path.join(report_dir, plan_id)
    if report_dir is None and default_report_dir and query_map.get("report", "") != "false":
        report_dir = default_report_dir
    if report_dir:
        try:
            builder.telemetry = run_report.RunTelemetry(plan.query, query_map, report_dir,
                                                        builder.device)
            builder.telemetry.plan_id = plan_id
            builder.telemetry.gateway = gateway
            builder.telemetry.fleet = fleet
            builder.telemetry.trace_id = trace_id
        except OSError as e:
            logger.warning("run telemetry unavailable (%s: %s); running unreported",
                           type(e).__name__, e)
    telemetry = builder.telemetry
    run_metrics = obs.Metrics()
    domain = run_domain.RunDomain(
        plan_id=plan_id, chaos=fault_plan,
        recorder=None if telemetry is None else telemetry.recorder, metrics=run_metrics)
    builder.run_metrics = run_metrics
    start = time.perf_counter()
    with run_domain.activate(domain):
        try:
            # one run attempt (fires when the plan has a scheduler.plan rule;
            # the executor's retry budget absorbs it)
            chaos.maybe_fire("scheduler.plan")
            if plan.trace_path:
                with obs.trace(plan.trace_path):
                    statistics = builder._execute(plan)
            else:
                statistics = builder._execute(plan)
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
