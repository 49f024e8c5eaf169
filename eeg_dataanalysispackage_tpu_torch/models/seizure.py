"""The seizure workload's query knobs and record, shared by the batch run
(``pipeline/builder.py``) and seizure serving (``serve/pipeline.py``):
the sliding-window geometry, the cost-sensitive class weights, the
classifiers that report the true confusion matrix, and the run's
``workload`` record (the JAX package's ``telemetry.workload``)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from . import registry
from ..epochs import sliding


def optional_int(query_map: Dict[str, str], name: str) -> Optional[int]:
    """An optional integer knob: None when absent or empty."""
    value = query_map.get(name, "")
    if not value:
        return None
    try:
        return int(value)
    except ValueError:
        raise ValueError(
            f"query parameter {name}= must be an integer, got {value!r}"
        )


def sliding_config(query_map: Dict[str, str]) -> sliding.SlidingConfig:
    """``window=`` (default 512), ``stride=`` (default half the window)
    and ``label_overlap=`` (default 0.5)."""
    window = optional_int(query_map, "window") or 512
    stride = optional_int(query_map, "stride") or max(1, window // 2)
    overlap = float(query_map.get("label_overlap") or 0.5)
    return sliding.SlidingConfig(window=window, stride=stride, label_overlap=overlap)


def seizure_classifier(name: str):
    """A registry classifier reporting the TRUE confusion matrix: the
    MLlib-path classifiers swap fp/fn in their P300 reports (the
    reference's bug-as-behavior, ``models/stats.from_arrays``), and the
    seizure workload's precision, recall and expected cost are computed
    from fp/fn."""
    clf = registry.create(name)
    clf.confusion_only_stats = False
    return clf


def seizure_weights(query_map: Dict[str, str], targets) -> tuple:
    """The cost-sensitive knobs -> ``(weight_pos, weight_neg, cost_fp,
    cost_fn)``. ``class_weight=balanced`` weights positives by the run's
    negative/positive ratio over all rows (before any split);
    ``class_weight=<float>`` sets the positive weight; otherwise the costs
    are the training weights (``weight_pos = cost_fn``). The costs always
    parameterize the expected-cost statistic."""
    cost_fp = float(query_map.get("cost_fp") or 1.0)
    cost_fn = float(query_map.get("cost_fn") or 1.0)
    if cost_fp <= 0 or cost_fn <= 0:
        raise ValueError(f"cost_fp=/cost_fn= must be > 0, got {cost_fp}/{cost_fn}")
    cw = query_map.get("class_weight", "")
    if cw == "balanced":
        n_pos = float(np.sum(np.asarray(targets) == 1.0))
        n_neg = float(len(targets) - n_pos)
        wp = (n_neg / n_pos) if n_pos > 0 else 1.0
        wn = 1.0
    elif cw:
        try:
            wp = float(cw)
        except ValueError:
            raise ValueError(f"class_weight= must be 'balanced' or a float, got {cw!r}")
        if wp <= 0:
            raise ValueError(f"class_weight= must be > 0, got {wp}")
        wn = 1.0
    else:
        wp, wn = cost_fn, cost_fp
    return wp, wn, cost_fp, cost_fn


def workload_record(cfg: sliding.SlidingConfig, targets: np.ndarray, weights: tuple,
                    fe) -> dict:
    """The run's ``workload`` record: the window geometry, the window and
    positive counts, the resolved ``weights`` (:func:`seizure_weights`)
    and the ``fe=`` config(s)."""
    n = len(targets)
    n_pos = int(np.sum(targets == 1.0))
    wp, wn, cost_fp, cost_fn = weights
    return {
        "task": "seizure",
        "window": cfg.window,
        "stride": cfg.stride,
        "label_overlap": cfg.label_overlap,
        "windows": n,
        "positives": n_pos,
        "class_ratio": round(n_pos / n, 6) if n else 0.0,
        "weight_pos": round(wp, 6),
        "weight_neg": round(wn, 6),
        "cost_fp": cost_fp,
        "cost_fn": cost_fn,
        "fe": fe,
    }
