"""The SIGKILL child of the executor's crash-recovery checks.

    python tests/_torch_scheduler_worker.py --device=cpu|cuda <journal_dir> <qa> <qb> <qc>

Runs a journaled ``PlanExecutor(max_concurrent=1)`` on the device: plan A
runs to completion, then B and C are submitted, and the process SIGKILLs
itself once B is mid-run (its features made, its training entered: B's
``_fit_and_test`` is held), so B's and C's records stay ``submitted``.
Before the kill it prints one JSON line, ``{"a_statistics", "k1_a",
"k1_before_kill"}``: A's statistics and the fused kernel's launch count in
this process after A and at the kill (0 on the CPU, where the kernel's
plain version runs).
"""

import json
import os
import signal
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from eeg_dataanalysispackage_tpu_torch.ops import ingest_cuda  # noqa: E402
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder  # noqa: E402
from eeg_dataanalysispackage_tpu_torch.scheduler import PlanExecutor  # noqa: E402


def main(argv) -> None:
    device = argv[0].split("=", 1)[1]
    journal_dir, qa, qb, qc = argv[1:5]
    ex = PlanExecutor(max_concurrent=1, journal_dir=journal_dir, device=device)
    a = ex.submit(qa).result(timeout=600)
    k1_a = ingest_cuda.LAUNCHES
    reached = threading.Event()

    def held(*args, **kwargs):
        reached.set()
        threading.Event().wait()

    PipelineBuilder._fit_and_test = held
    ex.submit(qb)
    ex.submit(qc)
    if not reached.wait(600):
        raise SystemExit("plan B never reached its training")
    print(json.dumps({"a_statistics": str(a.statistics), "k1_a": k1_a,
                      "k1_before_kill": ingest_cuda.LAUNCHES}), flush=True)
    os.kill(os.getpid(), signal.SIGKILL)


if __name__ == "__main__":
    main(sys.argv[1:])
