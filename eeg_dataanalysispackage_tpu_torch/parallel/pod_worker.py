"""One pod-member process: ``python -m
eeg_dataanalysispackage_tpu_torch.parallel.pod_worker --query=...``.

Port of the JAX package's ``parallel/pod_worker.py``. The query alone
decides pod membership (``processes=``/``coordinator=``/``process_id=``
ride in it; ``parallel/pod.spawn_pod_member`` builds it); the builder's
``_resolve_pod`` does the bootstrap. The worker runs
``runtime.execute_plan(ExecutionPlan.parse(query), builder)``, as the JAX
package's does, through ``PipelineBuilder(query, device=)``.

The last stdout line is one JSON object ``{"sha", "statistics"}``, with
``mesh`` (the run's mesh record), ``timers`` (stage seconds, the pod's
``exchange`` among them), ``metrics`` (the run's counters), ``k1`` (the
fused kernel's launches in this process), ``features_sha256`` (of the
run's float32 feature matrix, the exchanged one on a pod) and ``wall_s``
beside them.

``--parent-pid=N`` arms a watchdog: when the spawning process dies
(SIGKILL included: this process is reparented and ``os.getppid()``
changes) the member exits with :data:`ORPHANED_EXIT` instead of running
on for nobody. ``--device=cpu`` runs the member on the CPU (tests);
without it the member runs on the card.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
import time

#: exit code of a watchdog self-exit, distinct from a failed run
ORPHANED_EXIT = 70


def _watch_parent(parent_pid: int, poll_s: float = 0.5) -> None:
    def _loop():
        while True:
            if os.getppid() != parent_pid:
                os._exit(ORPHANED_EXIT)
            time.sleep(poll_s)

    threading.Thread(target=_loop, name="pod-worker-parent-watchdog", daemon=True).start()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    query = parent_pid = device = None
    for arg in argv:
        if arg.startswith("--query="):
            query = arg.split("=", 1)[1]
        elif arg.startswith("--parent-pid="):
            parent_pid = int(arg.split("=", 1)[1])
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            raise SystemExit(f"unknown argument {arg!r}")
    if not query:
        raise SystemExit("--query= is required")
    if parent_pid is not None:
        _watch_parent(parent_pid)

    from ..ops import ingest_cuda
    from ..pipeline.builder import PipelineBuilder
    from ..pipeline.plan import ExecutionPlan
    from ..scheduler import runtime

    plan = ExecutionPlan.parse(query)
    builder = PipelineBuilder(plan.query, device=device)
    ingest_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    statistics = runtime.execute_plan(plan, builder)
    wall = time.perf_counter() - t0
    text = str(statistics)
    features = builder.features
    print(json.dumps({
        "sha": hashlib.sha256(text.encode()).hexdigest(),
        "statistics": text,
        "mesh": builder.mesh_resolved,
        "timers": builder.timers,
        "metrics": builder.run_metrics.snapshot()["counters"],
        "k1": ingest_cuda.LAUNCHES,
        "features_sha256": None if features is None else hashlib.sha256(
            features.cpu().numpy().astype("float32").tobytes()).hexdigest(),
        "wall_s": wall,
    }, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
