"""Operator CLI for the plan service: audit journals and plan reports.

Usage:
    python -m eeg_dataanalysispackage_tpu_torch.tools.plan_admin list
            (--journal DIR | --gateway URL) [--tenant NAME]
    ... show <plan_id> (--journal DIR [--reports DIR] | --gateway URL)
    ... stats --gateway URL [--tenant NAME]
    ... tail --journal DIR [--interval S] [--count N]
    ... fleet --journal DIR
    ... trace <plan_id> --journal DIR [--trace-dir DIR]

The port's twin of the JAX package's ``tools/plan_admin.py``: the same
commands, flags, text and exit codes, over the port's
``scheduler.journal``, ``scheduler.lease`` and ``scheduler.placement``
(the two packages' journal, lease and trace files share one format).

``list`` renders every plan record as an aligned table (id, state,
attempts, timestamp, idempotency key, query) from a journal directory
(offline: a dead server's journal audits fine) or a running gateway.
``show`` prints one plan's record: the journaled statistics text, the
error and attempts, and the rendered ``run_report.json`` (through
:mod:`.obs_report`) when the per-plan report tree is reachable.
``stats`` prints a gateway's ``/stats`` payload, or with ``--tenant``
that tenant's serve block. ``tail`` follows a journal and prints records
as they land or change state. ``fleet`` joins every lease file to its
plan record (holder, pid and whether it lives, heartbeat age, ``STALE``
past the break threshold), lists unleased ``submitted`` records, and
the device pool when one ran over the journal.

``trace`` stitches one plan's distributed trace: the journaled trace id
(``meta.trace_id``) selects the lines of every ``trace-<segment>.jsonl``
file under ``--trace-dir`` (default ``EEG_TPU_TRACE_DIR``), and the
segments render as one tree ordered by wall start; a plan whose holder
was SIGKILLed shows the dead replica's segment, its open root marked
UNFINISHED, then the survivor's, with the takeover boundary named.
"""

import argparse
import glob
import json
import os
import sys
import tempfile
import time
import urllib.error
import urllib.request

from . import obs_report


def _http(url: str):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            return json.loads(e.read())
        except ValueError:
            raise SystemExit(f"{url}: HTTP {e.code}")
    except (urllib.error.URLError, OSError) as e:
        raise SystemExit(f"{url}: {e}")


def _journal(journal_dir: str, must_exist: bool = True):
    from ..scheduler.journal import PlanJournal

    if must_exist and not os.path.isdir(journal_dir):
        raise SystemExit(f"no such journal directory: {journal_dir}")
    return PlanJournal(journal_dir)


def _stamp(entry) -> str:
    return (entry.get("completed_utc") or entry.get("failed_utc")
            or entry.get("submitted_utc") or "")


def _rows_from_entries(entries):
    return [
        {
            "plan_id": e.get("plan_id", "?"),
            "state": e.get("state", "?"),
            "attempts": e.get("attempts", 0),
            "utc": _stamp(e),
            "key": (e.get("meta") or {}).get("idempotency_key") or "",
            "query": e.get("query", ""),
        }
        for e in entries
    ]


def _rows_from_gateway(url: str):
    payload = _http(url.rstrip("/") + "/plans")
    return [
        {"plan_id": p.get("plan_id", "?"), "state": p.get("state", "?"),
         "attempts": p.get("attempts", 0), "utc": "", "key": "", "query": p.get("query", "")}
        for p in payload.get("plans", [])
    ]


def cmd_list(args) -> int:
    rows = (_rows_from_gateway(args.gateway) if args.gateway
            else _rows_from_entries(_journal(args.journal).entries()))
    tenant = getattr(args, "tenant", None)
    if tenant:
        # a tenant-keyed plan names its tenant in its query string
        rows = [r for r in rows if tenant in r["query"]]
    if not rows:
        print(f"(no plan records mentioning tenant {tenant!r})" if tenant
              else "(no plan records)")
        return 0
    w = {k: max(len(k), *(len(str(r[k])) for r in rows))
         for k in ("plan_id", "state", "attempts", "utc", "key")}
    print(f"{'plan_id':<{w['plan_id']}}  {'state':<{w['state']}}  "
          f"{'attempts':>{w['attempts']}}  {'utc':<{w['utc']}}  "
          f"{'key':<{w['key']}}  query")
    for r in rows:
        query = r["query"]
        if len(query) > 80:
            query = query[:77] + "..."
        print(f"{r['plan_id']:<{w['plan_id']}}  {r['state']:<{w['state']}}  "
              f"{str(r['attempts']):>{w['attempts']}}  {r['utc']:<{w['utc']}}  "
              f"{str(r['key']):<{w['key']}}  {query}")
    states = {}
    for r in rows:
        states[r["state"]] = states.get(r["state"], 0) + 1
    print(f"\n{len(rows)} plans: " + "  ".join(f"{k}={v}" for k, v in sorted(states.items())))
    return 0


def _show_report(path: str, label: str) -> None:
    print(f"\n--- {label} ---")
    obs_report.show(path)


def _show_entry(entry, report_dir=None):
    meta = entry.get("meta") or {}
    print(f"plan     {entry.get('plan_id')}")
    print(f"state    {entry.get('state')}")
    print(f"query    {entry.get('query')}")
    for field in ("submitted_utc", "completed_utc", "failed_utc"):
        if entry.get(field):
            print(f"{field.split('_')[0]:<10}{entry[field]}")
    if entry.get("attempts"):
        print(f"attempts {entry['attempts']}")
    if meta.get("idempotency_key"):
        print(f"idempotency_key {meta['idempotency_key']}")
    if meta.get("gateway"):
        print(f"gateway  {meta['gateway']}")
    if meta.get("recovered"):
        print("recovered: resumed from a prior process's journal")
    if entry.get("error"):
        print(f"\nerror: {entry['error']}")
    if entry.get("statistics"):
        print(f"\nstatistics (sha256 {entry.get('statistics_sha256', '')[:16]}…):")
        print(entry["statistics"].rstrip("\n"))
    report_dir = report_dir or meta.get("report_dir")
    if report_dir:
        path = os.path.join(report_dir, "run_report.json")
        crash = os.path.join(report_dir, "crash_report.json")
        if os.path.exists(path):
            _show_report(path, f"run report ({path})")
        elif os.path.exists(crash):
            _show_report(crash, f"crash report ({crash})")
        else:
            print(f"\n(no report artifact under {report_dir})")


def cmd_show(args) -> int:
    if args.gateway:
        base = args.gateway.rstrip("/")
        status = _http(f"{base}/plans/{args.plan_id}")
        if "error" in status and "state" not in status:
            print(status["error"])
            return 1
        print(json.dumps(status, indent=2, sort_keys=True))
        if status.get("state") in ("completed", "failed", "cancelled"):
            report = _http(f"{base}/plans/{args.plan_id}/report")
            if report.get("statistics"):
                print(f"\nstatistics (sha256 "
                      f"{(report.get('statistics_sha256') or '')[:16]}…):")
                print(report["statistics"].rstrip("\n"))
            if report.get("error"):
                print(f"\nerror: {report['error']}")
            if report.get("run_report") is not None:
                # one rendering path for local and remote artifacts
                with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
                    json.dump(report["run_report"], f)
                try:
                    _show_report(f.name, "run report (via gateway)")
                finally:
                    os.unlink(f.name)
        return 0
    entry = _journal(args.journal, must_exist=False).entry(args.plan_id)
    if entry is None:
        print(f"no journal record for {args.plan_id} in {args.journal}")
        return 1
    _show_entry(entry, report_dir=(os.path.join(args.reports, args.plan_id)
                                   if args.reports else None))
    return 0


def cmd_stats(args) -> int:
    """A gateway's /stats payload, or one tenant's serve attribution."""
    payload = _http(args.gateway.rstrip("/") + "/stats")
    if not args.tenant:
        print(json.dumps(payload, indent=2, sort_keys=True))
        return 0
    serve = payload.get("serve")
    if not serve:
        print("gateway has no serve block (no prediction service attached)")
        return 1
    tenants = serve.get("tenants") or {}
    block = tenants.get(args.tenant)
    if block is None:
        print(f"unknown tenant {args.tenant!r}; registered: {sorted(tenants)}")
        return 1
    print(json.dumps({"tenant": args.tenant, **block, "tenant_quota": serve.get("tenant_quota"),
                      "rung": serve.get("rung")}, indent=2, sort_keys=True))
    return 0


def cmd_tail(args) -> int:
    """Print each record when it first appears and on every state change
    (``submitted`` before the run, then exactly one terminal record)."""
    seen, printed = {}, 0
    while True:
        for entry in _journal(args.journal).entries():
            pid, state = entry.get("plan_id"), entry.get("state")
            if seen.get(pid) == state:
                continue
            seen[pid] = state
            line = f"{_stamp(entry)}  {pid:<8} {state:<10}"
            if state == "completed":
                line += (f" attempts={entry.get('attempts')} sha256="
                         f"{(entry.get('statistics_sha256') or '')[:12]}…")
            elif state == "failed":
                line += f" {str(entry.get('error', ''))[:100]}"
            else:
                line += f" {entry.get('query', '')[:80]}"
            print(line, flush=True)
            printed += 1
            if args.count and printed >= args.count:
                return 0
        if args.count and printed >= args.count:
            return 0
        time.sleep(args.interval)


def _table(rows, cols) -> None:
    widths = {c: max(len(c), *(len(str(r[c])) for r in rows)) for c in cols}
    print("  ".join(f"{c:<{widths[c]}}" for c in cols))
    for r in rows:
        print("  ".join(f"{str(r[c]):<{widths[c]}}" for c in cols))


def cmd_fleet(args) -> int:
    """Lease files joined to plan records; offline, no live replica needed."""
    from ..scheduler import lease as lease_mod

    states = {e.get("plan_id"): e for e in _journal(args.journal).entries()}
    # an observer: this command never claims, so the holder is never written
    leases = lease_mod.LeaseDir(args.journal, holder="plan-admin")
    rows = []
    for info in leases.scan():
        entry = states.pop(info["plan_id"], None) or {}
        fleet_meta = (entry.get("meta") or {}).get("fleet") or {}
        rows.append({
            "plan_id": info["plan_id"],
            "state": entry.get("state", "(no record)"),
            "holder": info["holder"] or "?",
            "pid": f"{info['pid']}" + (" (dead)" if info["pid_dead"] else ""),
            "beat_age": f"{info['age_s']:.1f}s",
            "lease": "STALE" if info["stale"] else "held",
            "takeover": "yes" if fleet_meta.get("takeover") else "",
        })
    # unleased unfinished records: any replica's next scan claims them
    for plan_id in sorted(states):
        if states[plan_id].get("state") == "submitted":
            rows.append({"plan_id": plan_id, "state": "submitted", "holder": "-", "pid": "-",
                         "beat_age": "-", "lease": "unleased", "takeover": ""})
    print(f"journal {args.journal}  "
          f"(lease break threshold {lease_mod.lease_timeout():.0f}s + dead holder pid)")
    if not rows:
        print("(no leases and no unfinished records — fleet is idle)")
        return 0
    _table(rows, ("plan_id", "state", "holder", "pid", "beat_age", "lease", "takeover"))
    stale = sum(1 for r in rows if r["lease"] == "STALE")
    unleased = sum(1 for r in rows if r["lease"] == "unleased")
    print(f"\n{len(rows)} rows: {stale} stale (will be broken), "
          f"{unleased} unleased submitted (claimable)")
    _print_device_pool(args.journal)
    return 0


def _print_device_pool(journal_dir: str) -> None:
    """Per-ordinal holders and every waiting plan with its footprint, when
    a device pool has run over this journal (its marker file)."""
    from ..scheduler import placement

    size = placement.pool_size_marker(journal_dir)
    if size is None:
        return
    devices = placement.device_table(journal_dir)
    held = sum(1 for d in devices if not d["stale"])
    print(f"\ndevice pool: {size} ordinals, {held} held, {size - held} claimable")
    for d in devices:
        mark = "STALE" if d["stale"] else "held"
        print(f"  device {d['ordinal']:<3} {d['holder'] or '?':<16} {d['age_s']:>7.1f}s  {mark}")
    for w in placement.waiting_entries(journal_dir):
        fp = w.get("footprint") or {}
        age = max(0.0, time.time() - float(w.get("since", 0.0)))
        print(f"  WAITING {w.get('plan_id') or '?':<10} "
              f"blocked on devices={fp.get('devices')} hosts={fp.get('hosts')} "
              f"class={fp.get('memory_class')}  ({age:.1f}s, "
              f"promotes at {placement.promotion_age():.1f}s)")


def _load_trace_segments(trace_dir: str, trace_id: str):
    """The segments of ``trace_id`` among every ``trace-*.jsonl`` file
    under ``trace_dir``, ordered by wall start. A line that does not parse
    is skipped (a SIGKILLed writer can leave a torn last line). A segment
    whose header names a root span that never arrived belonged to a
    writer that died with it open: the root is synthesized, unfinished,
    so the dead holder's finished spans hang off a visible seam."""
    segments = {}
    for path in sorted(glob.glob(os.path.join(trace_dir, "trace-*.jsonl"))):
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError:
            continue
        for raw in lines:
            try:
                rec = json.loads(raw)
            except ValueError:
                continue
            if rec.get("trace_id") != trace_id:
                continue
            name = rec.get("segment") or os.path.basename(path)
            seg = segments.setdefault(name, {"segment": name, "wall_start": None,
                                             "takeover": False, "attrs": {},
                                             "root_span_id": None, "spans": []})
            if rec.get("kind") == "segment":
                attrs = rec.get("attrs") or {}
                seg.update(wall_start=rec.get("wall_start"), attrs=attrs,
                           takeover=bool(attrs.get("takeover")),
                           root_span_id=rec.get("root_span_id"))
            elif rec.get("kind") == "span":
                seg["spans"].append(rec)
                if seg["wall_start"] is None:
                    seg["wall_start"] = rec.get("wall_start")
    for seg in segments.values():
        root_id = seg["root_span_id"]
        if root_id and not any(s.get("span_id") == root_id for s in seg["spans"]):
            seg["spans"].insert(0, {"kind": "span", "span_id": root_id, "parent_id": None,
                                    "name": "(segment root)", "wall_start": seg["wall_start"],
                                    "wall_end": None, "attrs": dict(seg["attrs"])})
    return sorted(segments.values(), key=lambda s: (s["wall_start"] or 0.0, s["segment"]))


def _render_segment_spans(spans) -> int:
    """One segment's spans as an indented tree, wall order within a level;
    a span without an end is the dead holder's in-flight work."""
    by_id = {s["span_id"]: s for s in spans if s.get("span_id")}
    children, roots = {}, []
    for s in spans:
        parent = s.get("parent_id")
        if parent and parent in by_id:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)

    def wall(s):
        return s.get("wall_start") or 0.0

    def walk(span, depth):
        end = span.get("wall_end")
        timing = ("UNFINISHED (holder died mid-span)" if end is None
                  else f"{(end - wall(span)) * 1e3:.1f}ms")
        attrs = span.get("attrs") or {}
        extra = "".join(f" {k}={attrs[k]}" for k in sorted(attrs)
                        if k not in ("plan_id", "takeover"))
        print(f"  {'  ' * depth}{span.get('name', '?')}  {timing}{extra}")
        for child in sorted(children.get(span.get("span_id"), []), key=wall):
            walk(child, depth + 1)

    for root in sorted(roots, key=wall):
        walk(root, 0)
    return len(spans)


def cmd_trace(args) -> int:
    """One plan's cross-replica trace as a single tree, takeover named."""
    trace_dir = args.trace_dir or os.environ.get("EEG_TPU_TRACE_DIR")
    if not trace_dir:
        raise SystemExit("no trace directory: pass --trace-dir or set EEG_TPU_TRACE_DIR")
    entry = _journal(args.journal).entry(args.plan_id)
    if entry is None:
        print(f"no journal record for {args.plan_id} in {args.journal}")
        return 1
    trace_id = (entry.get("meta") or {}).get("trace_id")
    if not trace_id:
        print(f"plan {args.plan_id} has no journaled trace id (submitted "
              f"before tracing was enabled, or not via a gateway)")
        return 1
    segments = _load_trace_segments(trace_dir, trace_id)
    if not segments:
        print(f"trace {trace_id} (plan {args.plan_id}): no segments under "
              f"{trace_dir} — was EEG_TPU_TRACE_DIR set on the replicas?")
        return 1
    total = sum(len(s["spans"]) for s in segments)
    print(f"trace {trace_id}  plan {args.plan_id}  state {entry.get('state', '?')}  "
          f"— {len(segments)} segment(s), {total} span(s)")
    prev = None
    for seg in segments:
        marker = ""
        if seg["takeover"]:
            died = f" after {prev} died" if prev else ""
            marker = f"  <-- TAKEOVER boundary: continued{died}"
        print(f"\nsegment {seg['segment']}{marker}")
        _render_segment_spans(seg["spans"])
        prev = seg["segment"]
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="plan_admin", description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="command", required=True)
    p_list = sub.add_parser("list", help="table of all plan records")
    p_show = sub.add_parser("show", help="one plan's full record + report")
    p_show.add_argument("plan_id")
    p_stats = sub.add_parser("stats", help="gateway /stats (optionally one tenant's block)")
    p_stats.add_argument("--gateway", required=True)
    p_stats.add_argument("--tenant", help="print only this tenant's serve attribution")
    p_tail = sub.add_parser("tail", help="follow a journal directory")
    p_fleet = sub.add_parser("fleet", help="replication view: leases joined to plan records")
    p_fleet.add_argument("--journal", required=True)
    p_trace = sub.add_parser("trace",
                             help="one plan's cross-replica trace tree (takeover-aware)")
    p_trace.add_argument("plan_id")
    p_trace.add_argument("--journal", required=True)
    p_trace.add_argument("--trace-dir", dest="trace_dir",
                         help="trace segment directory (default: EEG_TPU_TRACE_DIR)")
    for p in (p_list, p_show):
        p.add_argument("--journal", help="journal directory")
        p.add_argument("--gateway", help="running gateway URL")
    p_list.add_argument("--tenant", help="only plans whose query mentions this tenant")
    p_show.add_argument("--reports",
                        help="per-plan report root (<root>/<plan_id>/run_report.json)")
    p_tail.add_argument("--journal", required=True)
    p_tail.add_argument("--interval", type=float, default=1.0)
    p_tail.add_argument("--count", type=int, default=0,
                        help="exit after N printed records (0 = follow forever)")
    args = parser.parse_args(argv)
    if args.command in ("list", "show") and bool(args.journal) == bool(args.gateway):
        parser.error("pass exactly one of --journal / --gateway")
    commands = {"list": cmd_list, "show": cmd_show, "stats": cmd_stats, "fleet": cmd_fleet,
                "trace": cmd_trace, "tail": cmd_tail}
    return commands[args.command](args)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except KeyboardInterrupt:
        sys.exit(130)
