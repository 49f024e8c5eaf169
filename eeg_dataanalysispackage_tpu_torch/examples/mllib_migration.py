"""Migrating models between a Spark MLlib deployment and the port.

Usage::

    python -m eeg_dataanalysispackage_tpu_torch.examples.mllib_migration \\
        [--device cpu] [--work DIR]

The reference persists trained classifiers with MLlib's own
``model.save(sc, path)``: parquet + JSON-metadata directories on the
cluster filesystem. This walkthrough shows both directions of the
interchange (``io/mllib_format.py``; ``pyarrow`` reads and writes the
parquet parts):

1. IMPORT: a model directory exactly as a Spark 1.6 deployment wrote it
   loads drop-in through the standard ``load()`` seam (and therefore
   through ``load_clf=...&load_name=<dir>`` queries), predicting with
   MLlib's own semantics: float64 margins, strict-greater thresholds,
   Vote combining for forests;
2. EXPORT: a random forest trained here (the host grower, its rows read
   from ``device``) writes a format-1.0 directory a Spark cluster can
   load back, for staged migrations that keep the old serving path alive.

No kernel runs on this path.
"""

import os
import sys
import tempfile

import numpy as np
import torch

from . import parser

FOREST_CONFIG = {
    "config_max_depth": "4",
    "config_max_bins": "16",
    "config_min_instances_per_node": "1",
    "config_impurity": "gini",
    "config_num_trees": "10",
    "config_feature_subset": "sqrt",
}


def run(device=None, n: int = 256, d: int = 48, work=None) -> dict:
    """Both directions on seeded rows (as float64 tensors on ``device``);
    returns the imported model's predictions beside the manual margins'
    and the forest's accuracy, predictions and round-trip agreement.
    ``work``: where the two model directories go (None: a temporary
    directory, removed at the end)."""
    from ..io import mllib_format as mf
    from ..models.linear import LogisticRegressionClassifier
    from ..models.trees import RandomForestClassifier
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    X = rng.randn(n, d)
    y = (X @ rng.randn(d) + 0.2 > 0).astype(np.float64)
    X_t = torch.from_numpy(X).to(dev)
    with tempfile.TemporaryDirectory(prefix="mllib_migration_") as tmp:
        root = work or tmp
        # -- 1. import a deployment's GLM model directory (the bytes
        # LogisticRegressionModel.save wrote)
        legacy_dir = os.path.join(root, "legacy_logreg_model")
        legacy_w = rng.randn(d) * 0.5
        mf.write_glm(legacy_dir, mf.GLM_LOGREG, legacy_w, intercept=0.1, threshold=0.5)
        clf = LogisticRegressionClassifier()
        clf.load(legacy_dir)  # detects the directory layout
        pred = clf.predict(X_t).cpu().numpy()
        manual = ((X @ legacy_w + 0.1) > 0.0).astype(np.float64)

        # -- 2. train here, export for the Spark serving path
        rf = RandomForestClassifier()
        rf.set_config(FOREST_CONFIG)
        rf.fit(X_t, torch.from_numpy(y).to(dev))
        rf_pred = rf.predict(X_t).cpu().numpy()
        acc = float((rf_pred == y).mean())
        # the forest stores binned thresholds; the export maps each split
        # back to its real-valued bin edge, so the Spark-side model is
        # self-contained
        export_dir = os.path.join(root, "exported_rf_model")
        rf.export_mllib_dir(export_dir)
        # round-trip proof: the exported directory loads back and agrees
        rf2 = RandomForestClassifier()
        rf2.load(export_dir)
        rf2_pred = rf2.predict(X_t).cpu().numpy()
    return {"device": str(dev), "legacy_dir": legacy_dir, "export_dir": export_dir,
            "imported_predictions": pred, "manual_predictions": manual,
            "bit_equal": bool(np.array_equal(pred, manual)), "forest_accuracy": acc,
            "forest_predictions": rf_pred, "round_trip_predictions": rf2_pred,
            "round_trip_agreement": float((rf2_pred == rf_pred).mean())}


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--work", default=None,
                    help="keep the two model directories here (default: a temporary one)")
    args = ap.parse_args(argv)
    out = run(args.device, work=args.work)
    if not out["bit_equal"]:
        raise AssertionError("the imported model's predictions differ from the manual ones")
    pred = out["imported_predictions"]
    print(f"imported {os.path.basename(out['legacy_dir'])}: "
          f"{int(pred.sum())}/{len(pred)} positive, "
          f"bit-equal to the JVM's double-margin predictions")
    print(f"exported rf (train acc {out['forest_accuracy']:.2f}) -> {out['export_dir']}; "
          f"round-trip prediction agreement {out['round_trip_agreement']:.2f}")
    print(f"no kernel on this path (rows on {out['device']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
