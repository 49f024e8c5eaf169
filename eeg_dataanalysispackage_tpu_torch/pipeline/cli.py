"""CLI entry point (reference: Main.java).

``python -m eeg_dataanalysispackage_tpu_torch.pipeline.cli '<query string>'``
mirrors ``spark-submit --class cz.zcu.kiv.Main <jar> '<query string>'``
(Main.java:38-51): args[0] is the query string; the run is on the CUDA
card; failures print a stack trace and exit non-zero.
"""

from __future__ import annotations

import logging
import sys
import traceback

from . import builder
from .. import obs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # the log file from LOGFILE_NAME, the -Dlogfile.name analogue
    obs.configure_logging(level=logging.INFO)
    log = logging.getLogger("eeg_dataanalysispackage_tpu_torch")
    log.info("Application started with arguments %s", argv)
    if not argv:
        log.error("usage: cli.py '<query string>' (e.g. "
                  "'info_file=...&fe=dwt-8-fused&train_clf=logreg')")
        return 2
    try:
        statistics = builder.PipelineBuilder(argv[0]).execute()
    except Exception:
        traceback.print_exc()
        return 1
    print(statistics, end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
