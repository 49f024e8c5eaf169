"""Train a P300 target/non-target classifier, two ways.

Usage::

    python -m eeg_dataanalysispackage_tpu_torch.examples.train_p300 path/to/info.txt [--device cpu]

1. the query-string surface: ``fe=dwt-8-tpu&train_clf=logreg`` through
   ``PipelineBuilder`` (host epochs; the features one ``torch.matmul`` of
   the epochs with the cascade matrix on the device);
2. the library API on the fused path: ``OfflineDataProvider
   .load_features_device`` (K1 once a recording, no host epochs) and a
   logreg fit on its rows.
"""

import os
import sys

import numpy as np
import torch

from . import k1_launches, kernel_line, parser


def run(info: str, device=None) -> dict:
    """Both ways on the session ``info`` names; returns the two
    statistics, the fused rows' shape and K1's launches."""
    from ..io import provider
    from ..models import registry as clf_registry
    from ..pipeline import builder
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    before = k1_launches()
    # --- way 1: the reference's query-string surface
    stats = builder.PipelineBuilder(
        f"info_file={info}&fe=dwt-8-tpu&train_clf=logreg"
        "&config_num_iterations=100&config_step_size=1.0"
        "&config_mini_batch_fraction=1.0", device=dev,
    ).execute()
    # --- way 2: the library API on the fused path
    features, targets = provider.OfflineDataProvider([info], device=dev).load_features_device()
    clf = clf_registry.create("logreg")
    clf.fit(features, torch.as_tensor(np.asarray(targets, np.float64), dtype=torch.float32,
                                      device=features.device))
    fused = clf.test_features(features, targets)
    return {"device": str(dev), "query_statistics": stats, "fused_statistics": fused,
            "features_shape": tuple(features.shape), "k1_launches": k1_launches() - before}


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("info", nargs="?", help="the session's info.txt")
    args = ap.parse_args(argv)
    if not args.info or not os.path.exists(args.info):
        sys.exit(f"info.txt not found: {args.info or '(no path given)'}")
    out = run(args.info, args.device)
    print("query-string pipeline:")
    print(out["query_statistics"])
    print("fused device path:", out["fused_statistics"])
    print(kernel_line(out["k1_launches"], out["device"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
