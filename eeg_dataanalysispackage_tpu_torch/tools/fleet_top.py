"""One view of a replica fleet: every replica's ``/metrics`` and
``/stats`` and the shared lease directory, rendered as one table.

Usage:
    python -m eeg_dataanalysispackage_tpu_torch.tools.fleet_top http://h:p1 http://h:p2 [--journal DIR]
    python -m eeg_dataanalysispackage_tpu_torch.tools.fleet_top ... --snapshot   # strict JSON

The port's twin of the JAX package's ``tools/fleet_top.py``, with the
same table, snapshot keys and exit code. A row a replica: plans
completed, serve requests, held leases, takeovers, the latency
histogram's p50/p99 and the per-tenant SLO verdicts off its ``/stats``.
Fleet-wide: the replicas' fixed-bucket histograms merged by integer
addition (``obs/metrics_export``: the merged p99 is the p99 of the union
of observations), summed counters, and with ``--journal`` the lease and
device-pool tables read off the shared directory. A replica that cannot
be scraped renders DOWN with its error; the table never refuses the
rest. ``--snapshot`` prints one JSON object with every non-finite float
written as null. Exit 0 when every replica is up, else 1.
"""

import argparse
import json
import math
import sys
import time
import urllib.error
import urllib.request

from ..obs import metrics_export


def _get_text(url: str, timeout_s: float = 10.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout_s) as r:
        return r.read().decode("utf-8", "replace")


def replica_snapshot(url: str, timeout_s: float = 10.0) -> dict:
    """One replica's row from its parsed ``/metrics`` and its ``/stats``
    (a scrape failure raises: the caller degrades the row)."""
    base = url.rstrip("/")
    series = metrics_export.parse(_get_text(base + "/metrics", timeout_s))
    stats = json.loads(_get_text(base + "/stats", timeout_s))

    def value(name: str) -> int:
        rows = series.get(f"eeg_tpu_{name}", [])
        return int(rows[0][1]) if rows else 0

    info = series.get("eeg_tpu_build_info", [])
    # the service-wide histogram is the series without a tenant label
    hist = metrics_export.histogram_from_series(
        series, "eeg_tpu_serve_request_latency_ms", match={"tenant": None})
    serve = stats.get("serve") or {}
    slo = {name: block.get("slo") for name, block in sorted((serve.get("tenants") or {}).items())
           if block.get("slo") is not None}
    if not slo and serve.get("slo") is not None:
        slo = {"(service)": serve["slo"]}
    fleet_block = stats.get("fleet") or {}
    return {
        "url": base,
        "replica": info[0][0].get("replica", "?") if info else "?",
        "draining": bool(fleet_block.get("draining")),
        "plans_completed": value("scheduler_completed_total"),
        "serve_completed": value("serve_completed_total"),
        "serve_shed": value("serve_shed_total"),
        "held_leases": value("fleet_held_leases"),
        "takeovers": value("lease_takeovers_total"),
        "devices_held": fleet_block.get("devices_held") or [],
        "device_pool": fleet_block.get("device_pool"),
        "latency_hist": None if hist is None else hist.snapshot(),
        "slo": slo,
    }


def _device_pool_table(journal_dir: str):
    """The shared device pool off the lease directory: per-ordinal rows,
    the free count and the waiting plans; None where no pool ran."""
    from ..scheduler import placement

    size = placement.pool_size_marker(journal_dir)
    if size is None:
        return None
    devices = placement.device_table(journal_dir)
    held = {row["ordinal"] for row in devices if not row["stale"]}
    return {
        "size": size,
        "devices": devices,
        "free": max(0, size - len(held)),
        "waiting": [
            {"plan_id": w.get("plan_id"), "footprint": w.get("footprint"),
             "age_s": round(max(0.0, time.time() - float(w.get("since", 0.0))), 2)}
            for w in placement.waiting_entries(journal_dir)
        ],
    }


def _lease_table(journal_dir: str) -> list:
    """The shared lease directory's rows (``plan_admin fleet``'s join,
    reduced to what the table shows)."""
    from ..scheduler import lease as lease_mod

    return [
        {"plan_id": info["plan_id"], "holder": info["holder"],
         "age_s": round(info["age_s"], 2), "stale": bool(info["stale"])}
        for info in lease_mod.LeaseDir(journal_dir, holder="fleet-top").scan()
    ]


def snapshot(urls, journal_dir=None, timeout_s: float = 10.0) -> dict:
    """The fleet as one JSON-safe dict: replica rows (a DOWN row carries
    ``error``), the merged histogram, summed counters, each tenant's worst
    SLO across replicas, and with ``journal_dir`` the lease and pool
    tables."""
    replicas = []
    for url in urls:
        try:
            replicas.append(replica_snapshot(url, timeout_s=timeout_s))
        except (urllib.error.URLError, OSError, ValueError) as e:
            replicas.append({"url": url.rstrip("/"), "replica": None,
                             "error": f"{type(e).__name__}: {e}"})
    up = [r for r in replicas if "error" not in r]
    merged = metrics_export.merge_all(
        metrics_export.LatencyHistogram.from_snapshot(r["latency_hist"])
        for r in up if r.get("latency_hist"))
    # a tenant is as healthy as its worst replica says
    tenant_slo = {}
    for r in up:
        for tenant, block in (r.get("slo") or {}).items():
            prior = tenant_slo.get(tenant)
            if prior is None or (block.get("error_budget_burn", 0)
                                 > prior.get("error_budget_burn", 0)):
                tenant_slo[tenant] = block
    fleet = {
        "replicas_total": len(replicas),
        "replicas_up": len(up),
        **{k: sum(r[k] for r in up) for k in ("plans_completed", "serve_completed",
                                              "serve_shed", "held_leases", "takeovers")},
        "latency_hist": None if merged is None else merged.snapshot(),
        "latency_p50_ms": None if merged is None else merged.quantile(50.0),
        "latency_p99_ms": None if merged is None else merged.quantile(99.0),
        "tenant_slo": tenant_slo,
        "devices_held": sum(len(r.get("devices_held") or []) for r in up),
    }
    snap = {"replicas": replicas, "fleet": fleet}
    if journal_dir:
        try:
            snap["leases"] = _lease_table(journal_dir)
        except OSError as e:
            snap["leases_error"] = f"{type(e).__name__}: {e}"
        try:
            pool = _device_pool_table(journal_dir)
            if pool is not None:
                snap["device_pool"] = pool
        except OSError as e:
            snap["device_pool_error"] = f"{type(e).__name__}: {e}"
    return snap


def _strict(obj):
    """``obj`` with every non-finite float replaced by None."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _strict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_strict(v) for v in obj]
    return obj


def _strict_dumps(obj, **kwargs) -> str:
    """Strict JSON: non-finite floats as null, and ``allow_nan=False``
    behind that, so none reaches the output."""
    return json.dumps(_strict(obj), allow_nan=False, **kwargs)


_COLS = ("replica", "state", "plans", "serve", "shed", "leases", "devices", "takeovers",
         "p50ms", "p99ms")


def _row(r: dict) -> dict:
    if "error" in r:
        return {**{c: "-" for c in _COLS}, "replica": r["url"], "state": "DOWN",
                "_error": r["error"]}
    hist = (metrics_export.LatencyHistogram.from_snapshot(r["latency_hist"])
            if r.get("latency_hist") else None)
    p50 = hist.quantile(50.0) if hist else None
    p99 = hist.quantile(99.0) if hist else None
    return {
        "replica": r["replica"],
        "state": "draining" if r["draining"] else "up",
        "plans": r["plans_completed"],
        "serve": r["serve_completed"],
        "shed": r["serve_shed"],
        "leases": r["held_leases"],
        "devices": ",".join(str(o) for o in r.get("devices_held") or []) or "-",
        "takeovers": r["takeovers"],
        "p50ms": "-" if p50 is None else f"{p50:g}",
        "p99ms": "-" if p99 is None else f"{p99:g}",
    }


def render(snap: dict) -> None:
    """The table over one :func:`snapshot`."""
    rows = [_row(r) for r in snap["replicas"]]
    widths = ({c: max(len(c), *(len(str(row[c])) for row in rows)) for c in _COLS}
              if rows else {c: len(c) for c in _COLS})
    print("  ".join(f"{c:<{widths[c]}}" for c in _COLS))
    for row in rows:
        print("  ".join(f"{str(row[c]):<{widths[c]}}" for c in _COLS))
        if row.get("_error"):
            print(f"    ({row['_error']})")
    fleet = snap["fleet"]
    p99 = fleet.get("latency_p99_ms")
    print(f"\nfleet: {fleet['replicas_up']}/{fleet['replicas_total']} up, "
          f"{fleet['plans_completed']} plans, {fleet['serve_completed']} serve requests "
          f"({fleet['serve_shed']} shed), {fleet['held_leases']} leases held, "
          f"{fleet['takeovers']} takeovers"
          + (f", merged p99 {p99:g}ms" if p99 is not None else ""))
    for tenant, slo in sorted((fleet.get("tenant_slo") or {}).items()):
        print(f"  slo {tenant}: {'OK' if slo.get('ok') else 'BURNING'}  "
              f"avail={slo.get('availability')} attain={slo.get('latency_attainment')} "
              f"burn={slo.get('error_budget_burn')} (objective {slo.get('objective_ms')}ms, "
              f"target {slo.get('availability_target')})")
    leases = snap.get("leases")
    if leases is not None:
        print(f"\nleases on disk: {len(leases)} ({sum(1 for r in leases if r['stale'])} stale)")
        for row in leases:
            print(f"  {row['plan_id']:<12} {row['holder'] or '?':<16} "
                  f"{row['age_s']:>7.2f}s  {'STALE' if row['stale'] else 'held'}")
    pool = snap.get("device_pool")
    if pool is not None:
        print(f"\ndevice pool: {pool['size']} ordinals, {pool['free']} free, "
              f"{len(pool['waiting'])} plan(s) waiting")
        for row in pool["devices"]:
            print(f"  device {row['ordinal']:<3} {row['holder'] or '?':<16} "
                  f"{row['age_s']:>7.2f}s  {'STALE' if row['stale'] else 'held'}")
        for w in pool["waiting"]:
            fp = w.get("footprint") or {}
            print(f"  waiting {w['plan_id'] or '?':<10} needs devices={fp.get('devices')} "
                  f"hosts={fp.get('hosts')} class={fp.get('memory_class')} "
                  f"({w['age_s']:.2f}s)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="fleet_top", description=__doc__.split("\n\n")[0])
    parser.add_argument("urls", nargs="+", help="replica base URLs (http://host:port)")
    parser.add_argument("--journal", help="shared journal dir (adds the lease table)")
    parser.add_argument("--snapshot", action="store_true",
                        help="emit one strict-JSON object instead of the table")
    parser.add_argument("--timeout", type=float, default=10.0)
    args = parser.parse_args(argv)
    snap = snapshot(args.urls, journal_dir=args.journal, timeout_s=args.timeout)
    if args.snapshot:
        print(_strict_dumps(snap, sort_keys=True))
    else:
        render(snap)
    return 0 if snap["fleet"]["replicas_up"] == len(args.urls) else 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except KeyboardInterrupt:
        sys.exit(130)
