"""Classification statistics (reference: Utils/ClassificationStatistics.java).

Confusion-matrix counts with the reference's accuracy/MSE math, rounding
rule (Math.round: half-up) and report text (ClassificationStatistics.java:
50-96), the seizure workload's imbalanced-class metrics and extended
report (:func:`mark_extended`; off by default, so every P300 report is
unchanged), :class:`WindowedStatistics`, the serving lifecycle's sliding
window of served outcomes, and the multi-model reports
:class:`PopulationStatistics` (``cv=``/``seeds=``/``sweep=`` members) and
:class:`FanOutStatistics` (``classifiers=`` legs), whose text is the JAX
package's byte for byte (its ``models/stats.py``).
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Optional

import numpy as np


def mark_extended(statistics, cost_fp: float = 1.0, cost_fn: float = 1.0) -> None:
    """Opt ``statistics`` into the extended imbalanced-class report
    (precision, recall, F1, balanced accuracy, expected cost) with the
    run's misclassification costs. Recurses through the dict-shaped
    reports (:class:`PopulationStatistics`, :class:`FanOutStatistics`),
    so every member's text carries the block."""
    if isinstance(statistics, dict):
        for member in statistics.values():
            mark_extended(member, cost_fp, cost_fn)
        return
    statistics.extended_report = True
    statistics.cost_fp = float(cost_fp)
    statistics.cost_fn = float(cost_fn)


def _java_round(x: float) -> int:
    """Java's ``Math.round`` for doubles: floor(x + 0.5)."""
    return int(math.floor(x + 0.5))


class ClassificationStatistics:
    def __init__(self, tp: int = 0, tn: int = 0, fp: int = 0, fn: int = 0):
        self.true_positives = tp
        self.true_negatives = tn
        self.false_positives = fp
        self.false_negatives = fn
        self.mse = 0.0
        self.class1_sum = 0.0  # sum of real outputs on expected-0 patterns
        self.class2_sum = 0.0  # sum of real outputs on expected-1 patterns
        # the seizure workload's report (mark_extended); off, the text is
        # the reference's
        self.extended_report = False
        self.cost_fp = 1.0  # cost of one false positive
        self.cost_fn = 1.0  # cost of one false negative

    def add(self, real_output: float, expected_output: float) -> None:
        """One pattern, accumulated incrementally
        (ClassificationStatistics.java:68-83)."""
        self.mse += (expected_output - real_output) ** 2
        e = _java_round(expected_output)
        r = _java_round(real_output)
        if e == 0:
            if e == r:
                self.true_negatives += 1
            else:
                self.false_positives += 1
            self.class1_sum += real_output
        elif e == 1:
            if e == r:
                self.true_positives += 1
            else:
                self.false_negatives += 1
            self.class2_sum += real_output

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

    # -- imbalanced-class metrics (the seizure workload); every 0/0 is NaN,
    # as accuracy's is

    def precision(self) -> float:
        denom = self.true_positives + self.false_positives
        return math.nan if denom == 0 else self.true_positives / denom

    def recall(self) -> float:
        denom = self.true_positives + self.false_negatives
        return math.nan if denom == 0 else self.true_positives / denom

    def specificity(self) -> float:
        denom = self.true_negatives + self.false_positives
        return math.nan if denom == 0 else self.true_negatives / denom

    def f1(self) -> float:
        p, r = self.precision(), self.recall()
        if math.isnan(p) or math.isnan(r) or (p + r) == 0:
            return math.nan
        return 2.0 * p * r / (p + r)

    def balanced_accuracy(self) -> float:
        r, s = self.recall(), self.specificity()
        if math.isnan(r) or math.isnan(s):
            return math.nan
        return (r + s) / 2.0

    def expected_cost(self, cost_fp: Optional[float] = None,
                      cost_fn: Optional[float] = None) -> float:
        """Mean per-pattern misclassification cost: each false positive
        bills ``cost_fp``, each false negative ``cost_fn`` (defaults: the
        run's costs)."""
        cfp = self.cost_fp if cost_fp is None else float(cost_fp)
        cfn = self.cost_fn if cost_fn is None else float(cost_fn)
        if self.num_patterns == 0:
            return math.nan
        return (cfp * self.false_positives + cfn * self.false_negatives) / self.num_patterns

    def extended_summary(self) -> dict:
        """The imbalanced-class metric block (the JAX package's report
        ``classification`` field of an extended run)."""
        return {
            "accuracy": self.calc_accuracy(),
            "precision": self.precision(),
            "recall": self.recall(),
            "specificity": self.specificity(),
            "f1": self.f1(),
            "balanced_accuracy": self.balanced_accuracy(),
            "cost_fp": self.cost_fp,
            "cost_fn": self.cost_fn,
            "expected_cost": self.expected_cost(),
        }

    def __str__(self) -> str:
        # Field order and wording match ClassificationStatistics.java:86-96.
        mse = math.nan if self.num_patterns == 0 else self.mse / self.num_patterns
        base = (
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
        if not self.extended_report:
            return base
        return base + (
            f"Precision: {self.precision()}\n"
            f"Recall: {self.recall()}\n"
            f"F1: {self.f1()}\n"
            f"Balanced accuracy: {self.balanced_accuracy()}\n"
            f"Expected cost (fp={self.cost_fp}, fn={self.cost_fn}): "
            f"{self.expected_cost()}\n"
        )


class WindowedStatistics:
    """Bounded sliding window of served (prediction, label) outcomes.

    The serving lifecycle's gate and drift currency
    (serve/lifecycle.py): expected cost and recall over the most recent
    ``window`` labeled outcomes, each rounded the reference's way.
    Host-side and deterministic: the same outcome stream gives the same
    numbers in any process. Reads and writes hold a lock, since the
    adapter thread appends while a monitor snapshots the stats block.
    """

    def __init__(self, window: int, cost_fp: float = 1.0, cost_fn: float = 1.0):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self.cost_fp = float(cost_fp)
        self.cost_fn = float(cost_fn)
        #: (prediction, label) pairs, oldest first, len <= window
        self._outcomes: deque = deque(maxlen=self.window)
        self._lock = threading.Lock()
        #: outcomes ever added (drift firing is paced against this)
        self.seen = 0

    def add(self, prediction: float, label: float) -> None:
        with self._lock:
            self._outcomes.append(
                (_java_round(float(prediction)), _java_round(float(label)))
            )
            self.seen += 1

    def reset(self) -> None:
        """Forget the window (a swapped-in model earns its own record);
        ``seen`` is kept."""
        with self._lock:
            self._outcomes.clear()

    @property
    def n(self) -> int:
        with self._lock:
            return len(self._outcomes)

    @property
    def full(self) -> bool:
        return self.n >= self.window

    def counts(self) -> tuple:
        """(tp, tn, fp, fn) over the window."""
        with self._lock:
            outcomes = list(self._outcomes)
        tp = tn = fp = fn = 0
        for r, e in outcomes:
            if e == 1:
                if r == 1:
                    tp += 1
                else:
                    fn += 1
            elif r == 0:
                tn += 1
            else:
                fp += 1
        return tp, tn, fp, fn

    def expected_cost(self) -> float:
        tp, tn, fp, fn = self.counts()
        total = tp + tn + fp + fn
        if total == 0:
            return math.nan
        return (self.cost_fp * fp + self.cost_fn * fn) / total

    def recall(self) -> float:
        tp, _tn, _fp, fn = self.counts()
        denom = tp + fn
        return math.nan if denom == 0 else tp / denom

    def summary(self) -> dict:
        tp, tn, fp, fn = self.counts()
        cost = self.expected_cost()
        recall = self.recall()
        return {
            "window": self.window,
            "n": self.n,
            "seen": self.seen,
            "tp": tp, "tn": tn, "fp": fp, "fn": fn,
            "expected_cost": None if math.isnan(cost) else round(cost, 6),
            "recall": None if math.isnan(recall) else round(recall, 6),
        }


class PopulationStatistics(dict):
    """Ordered ``{member label: ClassificationStatistics}`` of a population
    run (``models/population.py``), with ``shape`` (the population axes)
    and ``mode`` (``vmap`` or ``looped``: how the members trained).
    ``summary()`` is the cross-member digest (best member, mean and std
    accuracy) that ``str()`` and the population block embed."""

    def __init__(self, shape: dict | None = None, mode: str = "vmap"):
        super().__init__()
        self.shape = dict(shape or {})
        self.mode = mode

    def summary(self) -> dict:
        accs = {name: s.calc_accuracy() for name, s in self.items()}
        finite = {n: a for n, a in accs.items() if not math.isnan(a)}
        if not finite:
            return {"members": len(self), "best": None, "best_accuracy": math.nan,
                    "mean_accuracy": math.nan, "std_accuracy": math.nan}
        # the highest accuracy, the first label on ties
        best = max(sorted(finite), key=lambda n: finite[n])
        values = np.array([finite[n] for n in sorted(finite)])
        return {
            "members": len(self),
            "best": best,
            "best_accuracy": float(finite[best]),
            "mean_accuracy": float(values.mean()),
            "std_accuracy": float(values.std()),
        }

    def calc_accuracy(self) -> float:
        """The best member's accuracy: what a sweep selects."""
        return self.summary()["best_accuracy"]

    def __str__(self) -> str:
        # mode-free on purpose: the batched engine and its looped twin
        # render byte-equal reports for the same members
        s = self.summary()
        header = (
            f"population: {s['members']} members "
            f"(folds={self.shape.get('folds', 1)} "
            f"seeds={self.shape.get('seeds', 1)} "
            f"grid={self.shape.get('grid_points', 1)})\n"
            f"best member: {s['best']} "
            f"(accuracy {s['best_accuracy'] * 100}%)\n"
            f"mean accuracy: {s['mean_accuracy'] * 100}% "
            f"(std {s['std_accuracy'] * 100}%)\n"
        )
        members = "\n".join(f"member: {name}\n{stats}" for name, stats in self.items())
        return header + "\n" + members


class FanOutStatistics(dict):
    """Ordered ``{classifier name: statistics}`` of a ``classifiers=`` run;
    ``str()`` concatenates the legs' reports in request order (a leg that
    trained as a population holds a :class:`PopulationStatistics`)."""

    def __str__(self) -> str:
        return "\n".join(f"classifier: {name}\n{stats}" for name, stats in self.items())
