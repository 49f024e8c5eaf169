"""Run a query clean and under a chaos fault spec, and diff the two.

The port's twin of the JAX package's ``tools/chaos_run.py``: the query
runs twice through ``PipelineBuilder(query, device=)``, once without
faults and once with ``faults=<spec>`` (seeded by ``faults_seed=``), and
the two ``ClassificationStatistics`` texts are compared. Exit 0: parity
(the resilience machinery absorbed every injected fault); 1: the runs
diverged (a unified diff follows); 2: the chaos run died.

Usage::

    python -m eeg_dataanalysispackage_tpu_torch.tools.chaos_run \\
        'info_file=...&fe=dwt-8-fused&train_clf=logreg' \\
        --faults 'remote.request:p=0.2;ingest.read:once@1' [--seed 3] [--device cuda]

``--device`` defaults to ``cuda``. Add ``elastic=true&checkpoint_path=<dir>``
to the query when the spec injects ``device.step`` faults (mid-train
recovery needs the checkpointed train path); the chaos run's checkpoint
path gets ``-chaos`` appended, so it never resumes the clean run's
training. An exported ``EEG_TPU_FAULTS`` is ignored for both runs, and
the feature cache is off, so both runs exercise the whole pipeline.
"""

import argparse
import difflib
import json
import os
import sys


def _with_param(query: str, name: str, value: str) -> str:
    params = [p for p in query.split("&") if not p.startswith(name + "=")]
    params.append(f"{name}={value}")
    return "&".join(params)


def main(argv=None) -> int:
    from .. import obs
    from ..obs import chaos
    from ..pipeline import builder

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("query", help="pipeline query string (no faults= in it)")
    ap.add_argument("--faults", required=True, help="chaos fault spec")
    ap.add_argument("--seed", type=int, default=0, help="fault-plan seed")
    ap.add_argument("--device", default="cuda", help="the runs' device (default: cuda)")
    args = ap.parse_args(argv)

    query_map = builder.get_query_map(args.query)
    if builder.get_raw_param(args.query, "faults"):
        ap.error("put the spec in --faults, not in the query")
    # an exported spec would reach the clean run through the environment
    if os.environ.pop(chaos.ENV_SPEC, None):
        print(f"(ignoring exported {chaos.ENV_SPEC} for both runs)")
    # a cache hit would skip the very ingest paths the spec injects into
    os.environ["EEG_TPU_NO_FEATURE_CACHE"] = "1"

    print("== baseline (no faults) ==", flush=True)
    base_text = str(builder.PipelineBuilder(args.query, device=args.device).execute())
    print(base_text)

    chaos_query = _with_param(_with_param(args.query, "faults", args.faults),
                              "faults_seed", str(args.seed))
    if "checkpoint_path" in query_map:
        chaos_query = _with_param(chaos_query, "checkpoint_path",
                                  query_map["checkpoint_path"] + "-chaos")

    before = obs.metrics.snapshot()["counters"]
    print(f"\n== chaos run (faults={args.faults!r}, seed={args.seed}) ==", flush=True)
    try:
        chaos_text = str(builder.PipelineBuilder(chaos_query, device=args.device).execute())
    except Exception as e:
        print(f"CHAOS RUN DIED: {type(e).__name__}: {e}")
        return 2
    print(chaos_text)

    after = obs.metrics.snapshot()["counters"]
    events = {
        k: after[k] - before.get(k, 0.0)
        for k in sorted(after)
        if after[k] != before.get(k, 0.0)
        and k.split(".")[0] in ("chaos", "circuit", "elastic", "pipeline")
    }
    print("\n== resilience events ==")
    print(json.dumps(events, indent=2, sort_keys=True))

    if base_text == chaos_text:
        print("\nPARITY: statistics identical under injected faults")
        return 0
    print("\nDIVERGED: statistics differ under injected faults")
    sys.stdout.writelines(difflib.unified_diff(
        base_text.splitlines(keepends=True), chaos_text.splitlines(keepends=True),
        "baseline", "chaos"))
    return 1


if __name__ == "__main__":
    sys.exit(main())
