"""Classification statistics (reference: Utils/ClassificationStatistics.java).

Confusion-matrix counts with the reference's accuracy/MSE math, rounding
rule (Math.round: half-up) and report text (ClassificationStatistics.java:
50-96).
"""

from __future__ import annotations

import math

import numpy as np


class ClassificationStatistics:
    def __init__(self, tp: int = 0, tn: int = 0, fp: int = 0, fn: int = 0):
        self.true_positives = tp
        self.true_negatives = tn
        self.false_positives = fp
        self.false_negatives = fn
        self.mse = 0.0
        self.class1_sum = 0.0  # sum of real outputs on expected-0 patterns
        self.class2_sum = 0.0  # sum of real outputs on expected-1 patterns

    @classmethod
    def from_arrays(
        cls,
        real_outputs: np.ndarray,
        expected_outputs: np.ndarray,
        confusion_only: bool = False,
    ) -> "ClassificationStatistics":
        """Batched construction.

        ``confusion_only=True`` reproduces the reference's MLlib path,
        which builds statistics from the confusion matrix alone and
        leaves MSE/class sums at 0 (LogisticRegressionClassifier.java:
        133-138).

        Bug-as-behavior: the reference indexes Spark's *column-major*
        ``confusionMatrix().toArray()`` — actually [tn, fn, fp, tp] —
        as ``[tn, fp, fn, tp]``, so every MLlib-path report prints false
        positives and false negatives swapped. ``confusion_only=True``
        preserves that swap; accuracy is unaffected.
        """
        real = np.asarray(real_outputs, dtype=np.float64)
        exp = np.asarray(expected_outputs, dtype=np.float64)
        e = np.floor(exp + 0.5).astype(np.int64)
        r = np.floor(real + 0.5).astype(np.int64)
        true_fp = int(((e == 0) & (r != 0)).sum())
        true_fn = int(((e == 1) & (r != 1)).sum())
        if confusion_only:
            true_fp, true_fn = true_fn, true_fp
        stats = cls(
            tp=int(((e == 1) & (r == 1)).sum()),
            tn=int(((e == 0) & (r == 0)).sum()),
            fp=true_fp,
            fn=true_fn,
        )
        if not confusion_only:
            stats.mse = float(((exp - real) ** 2).sum())
            stats.class1_sum = float(real[e == 0].sum())
            stats.class2_sum = float(real[e == 1].sum())
        return stats

    @property
    def num_patterns(self) -> int:
        return (
            self.true_positives
            + self.true_negatives
            + self.false_positives
            + self.false_negatives
        )

    def calc_accuracy(self) -> float:
        # Java's int/int-widened-to-double 0/0 yields NaN, not a crash.
        if self.num_patterns == 0:
            return math.nan
        return (self.true_positives + self.true_negatives) / self.num_patterns

    def __str__(self) -> str:
        # Field order and wording match ClassificationStatistics.java:86-96.
        mse = math.nan if self.num_patterns == 0 else self.mse / self.num_patterns
        return (
            f"Number of patterns: {self.num_patterns}\n"
            f"True positives: {self.true_positives}\n"
            f"True negatives: {self.true_negatives}\n"
            f"False positives: {self.false_positives}\n"
            f"False negatives: {self.false_negatives}\n"
            f"Accuracy: {self.calc_accuracy() * 100}%\n"
            f"MSE: {mse}\n"
            f"Non-targets: {self.class1_sum}\n"
            f"Targets: {self.class2_sum}\n"
        )
