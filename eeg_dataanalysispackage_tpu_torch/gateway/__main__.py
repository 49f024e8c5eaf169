"""``python -m eeg_dataanalysispackage_tpu_torch.gateway``: serve the plan
service from the command line.

One replica of a three-replica fleet::

    python -m eeg_dataanalysispackage_tpu_torch.gateway \\
        --port 8321 --journal-dir /var/lib/eeg-tpu/journal \\
        --report-root /var/lib/eeg-tpu/reports --max-concurrent 4 \\
        --fleet --replica-id gw-a --device cuda

The journal directory makes the server crash-only: kill it mid-plan,
restart it with the same ``--journal-dir``, and recovery resumes every
unfinished plan under its original id. ``--fleet`` makes that fleet-wide:
N processes over one ``--journal-dir`` lease-claim plans from the shared
journal (``gateway/fleet.py``). ``--device`` is where the plans run
(default ``cuda``, which fails without a card; ``cpu`` for tests).

SIGTERM drains: stop accepting (503, ``/readyz`` not ready), release queued
leases for peers, finish the plans in flight, exit 0. The first line on
standard output names the bound port (``--port 0`` binds an ephemeral
one; ``EEG_TPU_GATEWAY_PORT`` sets the default).
"""

import argparse
import logging
import os
import signal
import sys
import threading

from .fleet import FleetReplica
from .server import ENV_PORT, GatewayServer


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="eeg_dataanalysispackage_tpu_torch.gateway",
        description="HTTP front door over the multi-tenant PlanExecutor")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address (default 127.0.0.1, loopback only)")
    parser.add_argument("--port", type=int, default=int(os.environ.get(ENV_PORT, "8321") or 8321),
                        help=f"bind port (default ${ENV_PORT} or 8321; 0 = ephemeral)")
    parser.add_argument("--journal-dir", default=None,
                        help="write-ahead journal directory (crash recovery and idempotent "
                             "re-submits across restarts; shared by every replica of a --fleet)")
    parser.add_argument("--report-root", default=None,
                        help="per-plan run_report.json tree (<root>/<plan_id>/)")
    parser.add_argument("--max-concurrent", type=int, default=2)
    parser.add_argument("--queue-depth", type=int, default=16)
    parser.add_argument("--max-attempts", type=int, default=3)
    parser.add_argument("--no-recover", action="store_true",
                        help="skip journal recovery at start (diagnostics only)")
    parser.add_argument("--fleet", action="store_true",
                        help="run as a replica of a shared-journal fleet (needs --journal-dir)")
    parser.add_argument("--replica-id", default=None,
                        help="this replica's fleet identity (default gw-<pid>)")
    parser.add_argument("--drain-timeout-s", type=float, default=60.0,
                        help="seconds a SIGTERM drain waits for plans in flight (default 60)")
    parser.add_argument("--device", default="cuda",
                        help="the device the plans run on (default cuda; cpu for tests)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.fleet and not args.journal_dir:
        parser.error("--fleet requires --journal-dir (the shared journal directory IS the "
                     "fleet)")
    server = GatewayServer(
        host=args.host, port=args.port, journal_dir=args.journal_dir,
        report_root=args.report_root, max_concurrent=args.max_concurrent,
        queue_depth=args.queue_depth, max_attempts=args.max_attempts,
        recover=not args.no_recover, replica_id=args.replica_id, device=args.device,
    )
    replica = FleetReplica(server=server) if args.fleet else None
    host, port = (replica or server).start()
    if server.recovery is not None:
        print(f"recovered journal: {len(server.recovery['completed'])} completed kept, "
              f"{len(server.recovery['resumed'])} unfinished resumed", file=sys.stderr)
    print(f"plan service listening on http://{host}:{port}"
          + (f" (fleet replica {server.replica_id})" if replica else ""), flush=True)

    # SIGTERM sets an event; the drain's journal and lease I/O runs here,
    # outside signal context
    stop = threading.Event()

    def _on_sigterm(signum, frame):
        server.draining = True  # refuse new work at once
        stop.set()

    signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        stop.wait()
    except KeyboardInterrupt:
        print("shutting down", file=sys.stderr)
        (replica or server).close()
        return 0
    if replica is not None:
        outcome = replica.drain(timeout_s=args.drain_timeout_s)
    else:
        server.draining = True
        drained = server.executor.drain_queued() if server.executor.journal is not None else []
        outcome = {"released": drained, "finished": [], "abandoned": []}
        server.close()
    print(f"drained: {len(outcome['released'])} released to peers, "
          f"{len(outcome['finished'])} finished in-flight, "
          f"{len(outcome['abandoned'])} abandoned", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
