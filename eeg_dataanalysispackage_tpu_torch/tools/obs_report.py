"""Render and diff run-report artifacts (the port's copy of the JAX
package's ``tools/obs_report.py``, with the same output).

Usage:
    python -m eeg_dataanalysispackage_tpu_torch.tools.obs_report show <run_report.json | crash_report.json>
    python -m eeg_dataanalysispackage_tpu_torch.tools.obs_report diff <a.json> <b.json>

``show`` renders one artifact (``obs/report.py`` schemas, either
package's) as an aligned summary: the stage table (total, count, mean,
min, max), cache attribution, the compilation block, degradation
history, top counters, span aggregates, and for crash reports the error
and the tail of the event ring.

``diff`` compares two run reports side by side: per-stage seconds with
the ratio, cache attribution, backend, mesh, dedup, lifecycle, gateway,
tenant, SLO, trace and population drift, compilation counts, and the
counters that changed. Exit code 0 always (a lens, not a gate).

Standard library only.
"""

import json
import os
import sys

_STAGE_COLS = ("seconds", "count", "mean_s", "min_s", "max_s")


def _load(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    schema = data.get("schema", "")
    if not schema.startswith(("eeg-tpu-run-report/", "eeg-tpu-crash-report/")):
        raise SystemExit(
            f"{path}: not a run/crash report (schema={schema!r})"
        )
    return data


def _fmt_stage_table(stages: dict) -> list:
    if not stages:
        return ["  (no stages recorded)"]
    rows = sorted(
        stages.items(), key=lambda kv: (-kv[1]["seconds"], kv[0])
    )
    width = max(len(n) for n, _ in rows)
    out = [
        f"  {'stage':<{width}}  {'total':>9}  {'count':>5}  "
        f"{'mean':>9}  {'min':>9}  {'max':>9}"
    ]
    for name, v in rows:
        out.append(
            f"  {name:<{width}}  {v['seconds']:9.4f}  {v['count']:>5}  "
            f"{v.get('mean_s', v['seconds'] / max(1, v['count'])):9.4f}  "
            f"{v.get('min_s', 0.0):9.4f}  {v.get('max_s', 0.0):9.4f}"
        )
    return out


def _fmt_population(block: dict, leg: str = "") -> list:
    """One population block (obs/report.py ``population`` field):
    the axes line, the cross-member summary, and the per-member
    accuracy table sorted best-first."""
    shape = block.get("shape", {})
    summary = block.get("summary", {})
    tag = f"{leg or block.get('classifier', '?')}"
    out = [
        f"  {tag}: {block.get('members')} members  "
        f"(folds={shape.get('folds')} {shape.get('cv_mode')} "
        f"seeds={shape.get('seeds')} grid={shape.get('grid_points')})  "
        f"mode={block.get('mode')}"
        + (
            f" (requested {block['requested_mode']})"
            if block.get("requested_mode") not in (None, block.get("mode"))
            else ""
        )
        + (
            f"  compiles={block['compiles']}"
            if block.get("compiles") is not None
            else ""
        )
    ]
    if summary:
        out.append(
            f"    best {summary.get('best')} "
            f"acc={summary.get('best_accuracy')}  "
            f"mean={summary.get('mean_accuracy')}  "
            f"std={summary.get('std_accuracy')}"
        )
    accuracy = block.get("accuracy") or {}
    if accuracy:
        width = max(len(k) for k in accuracy)
        ranked = sorted(accuracy.items(), key=lambda kv: (-kv[1], kv[0]))
        for member, acc in ranked:
            out.append(f"    {member:<{width}}  {acc}")
    return out


def _top_counters(metrics: dict, n: int = 12) -> list:
    counters = (metrics or {}).get("counters", {})
    rows = sorted(counters.items(), key=lambda kv: (-kv[1], kv[0]))[:n]
    if not rows:
        return ["  (no counters)"]
    width = max(len(k) for k, _ in rows)
    return [f"  {k:<{width}}  {v:g}" for k, v in rows]


def show(path: str) -> None:
    data = _load(path)
    crash = data["schema"].startswith("eeg-tpu-crash-report/")
    print(f"{'CRASH' if crash else 'RUN'} report  {path}")
    print(f"  schema   {data['schema']}")
    print(f"  outcome  {data.get('outcome')}")
    if "wall_s" in data:
        print(f"  wall     {data['wall_s']:.3f}s")
    print(f"  query    {data.get('query', '')}")
    dev = data.get("device", {})
    print(
        f"  device   {dev.get('platform')} x{dev.get('device_count', '?')}"
    )
    backend = data.get("backend") or {}
    if backend:
        print(
            f"  backend  requested={backend.get('requested')} "
            f"landed={backend.get('landed')}"
        )
    precision = data.get("precision")
    if precision:
        gate = precision.get("gate") or {}
        print(
            f"  precision requested={precision.get('requested')} "
            f"used={precision.get('used')} "
            f"gate_dev={gate.get('max_abs_dev')} "
            f"tol={gate.get('tolerance')}"
        )
    if data.get("overlap") is not None:
        print(f"  overlap  {data.get('overlap')}")
    dedup = data.get("dedup")
    if dedup:
        line = (
            f"  dedup    role={dedup.get('role')} "
            f"prefix={str(dedup.get('prefix_key'))[:16]}… "
            f"rows={dedup.get('rows')}"
        )
        if dedup.get("role") == "leader":
            line += f" build_s={dedup.get('build_seconds')}"
            if dedup.get("promoted_after_leader_failure"):
                line += " (promoted after leader failure)"
        else:
            line += (
                f" leader={dedup.get('leader_plan')} "
                f"bytes_saved={dedup.get('bytes_saved')} "
                f"seconds_saved={dedup.get('seconds_saved')}"
            )
        print(line)
    gateway = data.get("gateway")
    if gateway:
        print(
            f"  gateway  via={gateway.get('via')} "
            f"idempotency_key={gateway.get('idempotency_key')} "
            f"client={gateway.get('client')}"
        )
    trace = data.get("trace")
    if trace:
        print(
            f"  trace    id={trace.get('trace_id')} "
            f"segment={trace.get('segment')}"
            "  (stitch: plan_admin trace <plan-id>)"
        )
    mesh = data.get("mesh")
    if mesh:
        req = mesh.get("requested") or {}
        line = (
            f"  mesh     rung={mesh.get('rung')} "
            f"shape={mesh.get('shape')} "
            f"requested={req.get('devices')} "
            f"axes={','.join(req.get('axes') or [])}"
        )
        if mesh.get("error"):
            line += f"  error={mesh['error']}"
        print(line)
        # pod coordinates: live (top-level fields on the pod rung) or
        # requested-but-degraded (the pod sub-block with its evidence)
        pod = mesh.get("pod") or {}
        if mesh.get("rung") == "pod" or pod:
            src = pod or mesh
            pod_line = (
                f"           pod processes={src.get('processes')} "
                f"process_id={src.get('process_id')} "
                f"coordinator={src.get('coordinator')} "
                f"dcn_shape={mesh.get('dcn_shape')}"
            )
            if pod.get("error"):
                pod_line += f"  error={pod['error']}"
            print(pod_line)
        pop_mesh = mesh.get("population") or {}
        if pop_mesh:
            print(
                f"           population rung={pop_mesh.get('rung')} "
                f"members/device={pop_mesh.get('members_per_device')} "
                f"padded={pop_mesh.get('padded_members')}"
            )
    if crash:
        err = data.get("error", {})
        print(f"\nerror: {err.get('type')}: {err.get('message')}")
    workload = data.get("workload")
    if workload:
        print("\nworkload:")
        print(
            f"  task={workload.get('task')}  window="
            f"{workload.get('window')}  stride={workload.get('stride')}"
            f"  label_overlap={workload.get('label_overlap')}"
        )
        print(
            f"  windows={workload.get('windows')}  positives="
            f"{workload.get('positives')}  class_ratio="
            f"{workload.get('class_ratio')}"
        )
        print(
            f"  weight_pos={workload.get('weight_pos')}  weight_neg="
            f"{workload.get('weight_neg')}  cost_fp="
            f"{workload.get('cost_fp')}  cost_fn={workload.get('cost_fn')}"
        )
    classification = data.get("classification")
    if classification:
        print("\nclassification (extended metrics):")
        blocks = (
            classification
            if all(isinstance(v, dict) for v in classification.values())
            else {"": classification}
        )
        for member, block in blocks.items():
            if block is None:
                continue
            prefix = f"  {member}: " if member else "  "
            print(
                f"{prefix}precision={block.get('precision')} "
                f"recall={block.get('recall')} f1={block.get('f1')} "
                f"balanced_acc={block.get('balanced_accuracy')} "
                f"expected_cost={block.get('expected_cost')} "
                f"(fp={block.get('cost_fp')}, fn={block.get('cost_fn')})"
            )
    pop = data.get("population")
    if pop:
        print("\npopulation:")
        # train_clf= runs carry one block; fan-out runs one per leg
        blocks = pop.get("legs", {"": pop}) if isinstance(pop, dict) else {}
        for leg, block in blocks.items():
            for line in _fmt_population(block, leg):
                print(line)
    serve = data.get("serve")
    if serve:
        print("\nserve:")
        req = serve.get("requests", {})
        lat = serve.get("latency_ms", {})
        print(
            f"  mode={serve.get('mode')}  batches="
            f"{serve.get('batches')}  mean_batch="
            f"{serve.get('mean_batch_size')}"
        )
        print(
            f"  completed={req.get('completed')}  shed="
            f"{req.get('shed')}  deadline_exceeded="
            f"{req.get('deadline_exceeded')}  failed="
            f"{req.get('failed')}  retries={req.get('retries')}"
        )
        print(
            f"  latency p50={lat.get('p50')}ms p99={lat.get('p99')}ms "
            f"max={lat.get('max')}ms  drained="
            f"{serve.get('drained_cleanly')}  wedged="
            f"{serve.get('wedged')}"
        )
        slo = serve.get("slo")
        if slo:
            print(
                f"  slo {'OK' if slo.get('ok') else 'BURNING'}  "
                f"avail={slo.get('availability')} "
                f"attain={slo.get('latency_attainment')} "
                f"burn={slo.get('error_budget_burn')}  "
                f"(objective {slo.get('objective_ms')}ms, target "
                f"{slo.get('availability_target')})"
            )
        tenants = serve.get("tenants") or {}
        if tenants:
            print(
                f"  tenants={len(tenants)}  quota="
                f"{serve.get('tenant_quota')}  resident_bytes="
                f"{serve.get('resident_weight_bytes')}"
            )
            width = max(len(name) for name in tenants)
            for name in sorted(tenants):
                t = tenants[name]
                treq = t.get("requests", {})
                tlat = t.get("latency_ms", {})
                tslo = t.get("slo") or {}
                slo_tail = (
                    f"  slo={'OK' if tslo.get('ok') else 'BURN'}"
                    f"(burn={tslo.get('error_budget_burn')})"
                    if tslo else ""
                )
                print(
                    f"    {name:<{width}}  lane={t.get('lane')} "
                    f"gen={t.get('generation')}  completed="
                    f"{treq.get('completed')} shed={treq.get('shed')} "
                    f"deadline={treq.get('deadline_exceeded')} "
                    f"failed={treq.get('failed')}  p50="
                    f"{tlat.get('p50')}ms p99={tlat.get('p99')}ms"
                    f"{slo_tail}"
                )
    lifecycle = data.get("lifecycle")
    if lifecycle:
        print("\nlifecycle:")
        fb = lifecycle.get("feedback") or {}
        print(
            f"  state={lifecycle.get('state')}  generation="
            f"{lifecycle.get('generation')}  swaps="
            f"{lifecycle.get('swaps')}  rollbacks="
            f"{lifecycle.get('rollbacks')}  drift="
            f"{lifecycle.get('drift_events')}  wedged="
            f"{lifecycle.get('wedged')}"
        )
        print(
            f"  feedback received={fb.get('received')} dropped="
            f"{fb.get('dropped')}  batches={fb.get('batches')} "
            f"chunks={fb.get('chunks')} failures={fb.get('failures')}"
        )
        lw = lifecycle.get("live_window") or {}
        print(
            f"  live window n={lw.get('n')}/{lw.get('window')}  "
            f"expected_cost={lw.get('expected_cost')}  recall="
            f"{lw.get('recall')}  baseline_cost="
            f"{lifecycle.get('baseline_cost')}"
        )
        cand = lifecycle.get("candidate")
        if cand:
            cw = cand.get("window") or {}
            print(
                f"  candidate g{cand.get('generation')} "
                f"batches={cand.get('batches')} t={cand.get('t')} "
                f"rows={cand.get('rows')}  shadow cost="
                f"{cw.get('expected_cost')} recall={cw.get('recall')}"
            )
        gate = lifecycle.get("gate")
        if gate:
            print(
                f"  gate {lifecycle.get('config', {}).get('swap_gate')}:"
                f" candidate_cost={gate.get('candidate_cost')} "
                f"live_cost={gate.get('live_cost')} "
                f"promote={gate.get('promote')}"
            )
        if lifecycle.get("promoted_path"):
            print(f"  promoted  {lifecycle.get('promoted_path')}")
        ckpt = lifecycle.get("checkpoint")
        if ckpt:
            print(
                f"  checkpoint {ckpt.get('dir')} "
                f"(steps retained: {ckpt.get('steps')})"
            )
    deg = data.get("degradation") or []
    if deg:
        print("\ndegradation history:")
        for step in deg:
            print(f"  {step}")
    print("\nstages:")
    for line in _fmt_stage_table(data.get("stages", {})):
        print(line)
    caches = data.get("caches", {})
    print(
        f"\ncaches: feature={caches.get('feature_cache')} "
        f"plan={caches.get('plan_cache')} "
        f"compile_dir={caches.get('compile_cache_dir')}"
    )
    xla = data.get("xla", {})
    print(
        f"xla: compilations={xla.get('compilations')} "
        f"backend_compile_s={xla.get('backend_compile_s')}"
    )
    chaos = data.get("chaos")
    if chaos:
        print(f"chaos: spec={chaos.get('spec')!r} seed={chaos.get('seed')}")
        for point, rule in (chaos.get("rules") or {}).items():
            print(
                f"  {point}: calls={rule['calls']} fired={rule['fired']}"
            )
    spans = data.get("spans", {})
    by_name = spans.get("by_name", {})
    if by_name:
        print(
            f"\nspans ({spans.get('span_count')} total, "
            f"{spans.get('dropped_spans', 0)} dropped):"
        )
        width = max(len(k) for k in by_name)
        for name, agg in by_name.items():
            print(
                f"  {name:<{width}}  x{agg['count']:<5} "
                f"{agg['seconds']:9.4f}s  "
                f"[{agg['min_s']:.4f} .. {agg['max_s']:.4f}]"
            )
    print("\ntop metrics counters:")
    for line in _top_counters(data.get("metrics", {})):
        print(line)
    if crash:
        events = data.get("events") or []
        print(f"\nflight recorder (last {len(events)} events):")
        for ev in events[-20:]:
            print(
                f"  t={ev['t']:9.4f}  {ev['name']:<28} "
                f"span={ev.get('span_name')}  {ev.get('attrs') or ''}"
            )
        fleet_ctx = data.get("fleet_context")
        if fleet_ctx:
            counters = fleet_ctx.get("lease_counters") or {}
            print(
                f"\nfleet context: replica={fleet_ctx.get('replica')} "
                f"takeover={fleet_ctx.get('takeover')} "
                f"held_leases={fleet_ctx.get('held_leases')}"
            )
            if counters:
                print(
                    "  lease counters: "
                    + "  ".join(
                        f"{k}={v}" for k, v in sorted(counters.items())
                    )
                )


def diff(path_a: str, path_b: str) -> None:
    a, b = _load(path_a), _load(path_b)
    print(f"A: {path_a}")
    print(f"B: {path_b}")
    wall_a, wall_b = a.get("wall_s"), b.get("wall_s")
    if wall_a and wall_b:
        print(
            f"\nwall: A {wall_a:.3f}s  B {wall_b:.3f}s  "
            f"(B/A = {wall_b / wall_a:.2f}x)"
        )
    ba, bb = a.get("backend") or {}, b.get("backend") or {}
    if ba != bb:
        print(f"backend: A {ba}  B {bb}")

    def _mesh_digest(report):
        mesh = report.get("mesh")
        if not mesh:
            return None
        pop = mesh.get("population") or {}
        return {
            "rung": mesh.get("rung"),
            "shape": mesh.get("shape"),
            "members_per_device": pop.get("members_per_device"),
            "processes": mesh.get("processes")
            or (mesh.get("pod") or {}).get("processes"),
        }

    ma, mb = _mesh_digest(a), _mesh_digest(b)
    if (ma or mb) and ma != mb:
        print(f"mesh (rung, shape, members/device): A {ma}  B {mb}")

    def _dedup_digest(report):
        dedup = report.get("dedup")
        if not dedup:
            return None
        return {
            "role": dedup.get("role"),
            "prefix": str(dedup.get("prefix_key"))[:16],
            "leader": dedup.get("leader_plan"),
            "bytes_saved": dedup.get("bytes_saved"),
            "seconds_saved": dedup.get(
                "seconds_saved", dedup.get("build_seconds")
            ),
        }

    dda, ddb = _dedup_digest(a), _dedup_digest(b)
    if (dda or ddb) and dda != ddb:
        print(f"dedup (role, prefix, leader, saved): A {dda}  B {ddb}")

    def _lifecycle_digest(report):
        lc = report.get("lifecycle")
        if not lc:
            return None
        return {
            "state": lc.get("state"),
            "generation": lc.get("generation"),
            "swaps": lc.get("swaps"),
            "rollbacks": lc.get("rollbacks"),
            "drift": lc.get("drift_events"),
            "batches": (lc.get("feedback") or {}).get("batches"),
            "live_cost": (lc.get("live_window") or {}).get(
                "expected_cost"
            ),
        }

    la, lb = _lifecycle_digest(a), _lifecycle_digest(b)
    if (la or lb) and la != lb:
        print(
            f"lifecycle (state, gen, swaps, rollbacks, drift): "
            f"A {la}  B {lb}"
        )
    ga, gb = a.get("gateway") or {}, b.get("gateway") or {}
    if (ga or gb) and ga != gb:
        print(f"gateway: A {ga}  B {gb}")

    def _tenant_digest(report):
        tenants = (report.get("serve") or {}).get("tenants")
        if not tenants:
            return None
        return {
            name: (
                t.get("lane"), t.get("generation"),
                (t.get("requests") or {}).get("completed"),
                (t.get("requests") or {}).get("shed"),
                (t.get("slo") or {}).get("ok"),
            )
            for name, t in tenants.items()
        }

    ta, tb = _tenant_digest(a), _tenant_digest(b)
    if (ta or tb) and ta != tb:
        print(
            f"serve tenants (lane, gen, completed, shed, slo_ok): "
            f"A {ta}  B {tb}"
        )

    def _slo_digest(report):
        slo = (report.get("serve") or {}).get("slo")
        if not slo:
            return None
        return {
            "ok": slo.get("ok"),
            "availability": slo.get("availability"),
            "attainment": slo.get("latency_attainment"),
            "burn": slo.get("error_budget_burn"),
        }

    slo_a, slo_b = _slo_digest(a), _slo_digest(b)
    if (slo_a or slo_b) and slo_a != slo_b:
        print(f"serve slo (ok, avail, attain, burn): A {slo_a}  B {slo_b}")
    tr_a = (a.get("trace") or {}).get("trace_id")
    tr_b = (b.get("trace") or {}).get("trace_id")
    if (tr_a or tr_b) and tr_a != tr_b:
        print(f"trace: A {tr_a}  B {tr_b}")

    def _pop_digest(report):
        pop = report.get("population")
        if not pop:
            return None
        blocks = pop.get("legs", {"": pop})
        return {
            leg or blk.get("classifier", "?"): (
                blk.get("members"), blk.get("mode"),
                (blk.get("summary") or {}).get("best_accuracy"),
            )
            for leg, blk in blocks.items()
        }

    pa, pb = _pop_digest(a), _pop_digest(b)
    if (pa or pb) and pa != pb:
        print(f"population (members, mode, best acc): A {pa}  B {pb}")
    da, db = a.get("degradation") or [], b.get("degradation") or []
    if len(da) != len(db):
        print(f"degradation steps: A {len(da)}  B {len(db)}")

    print("\nstages (A vs B):")
    stages_a, stages_b = a.get("stages", {}), b.get("stages", {})
    names = sorted(set(stages_a) | set(stages_b))
    if names:
        width = max(len(n) for n in names)
        for name in names:
            sa = stages_a.get(name, {}).get("seconds", 0.0)
            sb = stages_b.get(name, {}).get("seconds", 0.0)
            ratio = f"{sb / sa:7.2f}x" if sa > 0 else "      --"
            print(
                f"  {name:<{width}}  A {sa:9.4f}s  B {sb:9.4f}s  {ratio}"
            )

    print("\ncaches:")
    for kind in ("feature_cache", "plan_cache"):
        ca = (a.get("caches") or {}).get(kind)
        cb = (b.get("caches") or {}).get(kind)
        marker = " " if ca == cb else "*"
        print(f" {marker} {kind}: A {ca}  B {cb}")
    xa, xb = a.get("xla", {}), b.get("xla", {})
    print(
        f"\nxla: A compilations={xa.get('compilations')} "
        f"({xa.get('backend_compile_s')}s)  "
        f"B compilations={xb.get('compilations')} "
        f"({xb.get('backend_compile_s')}s)"
    )

    ca = (a.get("metrics") or {}).get("counters", {})
    cb = (b.get("metrics") or {}).get("counters", {})
    changed = {
        k for k in set(ca) | set(cb) if ca.get(k, 0) != cb.get(k, 0)
    }
    if changed:
        print("\nmetrics counters that differ:")
        width = max(len(k) for k in changed)
        for k in sorted(changed):
            print(
                f"  {k:<{width}}  A {ca.get(k, 0):g}  B {cb.get(k, 0):g}"
            )
    sa = a.get("statistics_sha256")
    sb = b.get("statistics_sha256")
    if sa and sb:
        verdict = "IDENTICAL" if sa == sb else "DIFFER"
        print(f"\nstatistics: {verdict} (A {sa[:12]}… B {sb[:12]}…)")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) >= 2 and argv[0] == "show":
        show(argv[1])
        return 0
    if len(argv) >= 3 and argv[0] == "diff":
        diff(argv[1], argv[2])
        return 0
    print(__doc__)
    return 2


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # a reader closing the pipe early (``show ... | head``) is fine
        sys.stdout = open(os.devnull, "w")
        sys.exit(0)
