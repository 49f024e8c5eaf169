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
  report write failure is logged and never fails the run it observed;
- with a ``trace_id`` and ``EEG_TPU_TRACE_DIR`` set, joins the plan's span
  recorder (a standalone 512-span recorder when the plan is unreported) to
  the trace: its segment is the fleet replica (else the gateway's), its
  root carries ``plan_id`` and ``takeover``, and its spans go to
  ``<dir>/trace-<segment>.jsonl``. A takeover re-submits with the
  journaled trace id, so the survivor's segment continues the dead
  holder's trace.

``placement`` (the device pool's leased ordinals, ``scheduler/placement.py``)
sets ``builder.placement_devices``: a meshed plan's mesh is built from
exactly those ordinals, and a single-device plan's one ordinal is a capacity
token (it runs on the builder's device, as in the JAX package). The JAX
package's persistent compile cache has no counterpart (the CUDA kernels are
built by ``nvcc`` outside any run).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

from .. import obs
from ..obs import chaos, domain as run_domain, events
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
    query_map = plan.query_map
    logger.info("query: %s", query_map)
    if fault_plan is _RESOLVE:
        fault_plan = resolve_fault_plan(plan)
    builder.telemetry = None
    builder.placement_devices = tuple(placement) if placement else None
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
    recorder = None if telemetry is None else telemetry.recorder
    standalone = None
    trace_dir = os.environ.get(events.ENV_TRACE_DIR) if trace_id else None
    if trace_dir:
        if recorder is None:
            recorder = standalone = events.SpanRecorder(name="plan", max_spans=512)
        recorder.set_trace(
            trace_id, trace_dir=trace_dir,
            segment=(fleet or {}).get("replica") or (gateway or {}).get("replica"),
            plan_id=plan_id, takeover=bool((fleet or {}).get("takeover")))
    run_metrics = obs.Metrics()
    domain = run_domain.RunDomain(plan_id=plan_id, chaos=fault_plan, recorder=recorder,
                                  metrics=run_metrics)
    builder.run_metrics = run_metrics
    try:
        return _run_in_domain(plan, builder, domain, telemetry, run_metrics)
    finally:
        if standalone is not None:
            # close the unreported plan's segment (its root span goes to
            # the file); a report's recorder is finished by its writer
            standalone.finish()


def _run_in_domain(plan, builder, domain, telemetry, run_metrics):
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
    telemetry.dedup = builder.dedup_resolved
    telemetry.population = builder.population_block
    telemetry.workload = builder.workload_block
    serve = builder.serve_block
    if serve is not None:
        serve = dict(serve)
        telemetry.lifecycle = serve.pop("lifecycle", None)
    telemetry.serve = serve
