"""Deterministic fixed-bucket latency histograms and the SLO block.

Port of the part of the JAX package's ``obs/metrics_export.py`` that the
serving layer reads: :class:`LatencyHistogram` (``serve/batcher.py``
observes every completed request into one) and :func:`slo_block`
(``serve/service.py``'s stats block). Fixed buckets and integer counts,
so two histograms merge by exact integer addition.
"""

from __future__ import annotations

import bisect
from typing import List, Mapping, Optional, Sequence, Tuple

#: Shared latency bucket upper bounds, milliseconds. The +Inf bucket is
#: implicit (``counts`` carries one extra slot).
BUCKET_BOUNDS_MS: Tuple[float, ...] = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0,
)


class LatencyHistogram:
    """Bounded fixed-bucket latency histogram, mergeable by exact
    integer addition.

    Not thread-safe by itself — callers that observe from multiple
    threads hold their own lock (serve/batcher.py observes under its
    counters lock). ``sum`` is kept in integer microseconds so merges
    are exact.
    """

    __slots__ = ("bounds", "counts", "count", "sum_us")

    def __init__(self, bounds: Sequence[float] = BUCKET_BOUNDS_MS):
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly increasing")
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum_us = 0

    def observe(self, latency_ms: float) -> None:
        """Record one observation (milliseconds)."""
        ms = float(latency_ms)
        # le-buckets: an observation exactly on a bound lands in it
        self.counts[bisect.bisect_left(self.bounds, ms)] += 1
        self.count += 1
        self.sum_us += int(round(ms * 1000.0))

    @property
    def sum_ms(self) -> float:
        return self.sum_us / 1000.0

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold ``other`` into this histogram in place — exact integer
        addition."""
        if other.bounds != self.bounds:
            raise ValueError(
                f"cannot merge histograms with different bounds: "
                f"{self.bounds} vs {other.bounds}"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum_us += other.sum_us
        return self

    def snapshot(self) -> dict:
        """JSON-safe state."""
        return {
            "bounds_ms": list(self.bounds),
            "counts": list(self.counts),
            "count": self.count,
            "sum_ms": round(self.sum_ms, 3),
        }

    @classmethod
    def from_snapshot(cls, snap: Mapping) -> "LatencyHistogram":
        h = cls(snap["bounds_ms"])
        counts = [int(c) for c in snap["counts"]]
        if len(counts) != len(h.counts):
            raise ValueError("snapshot counts do not match bounds")
        h.counts = counts
        h.count = int(snap.get("count", sum(counts)))
        # sum_ms round-trips through the snapshot at ms resolution
        h.sum_us = int(round(float(snap.get("sum_ms", 0.0)) * 1000.0))
        return h

    def attainment(self, objective_ms: float) -> float:
        """Fraction of observations at or under ``objective_ms``
        (resolved to the smallest bucket bound >= the objective — the
        histogram's conservative answer). 1.0 with no observations."""
        if self.count == 0:
            return 1.0
        idx = bisect.bisect_left(self.bounds, float(objective_ms))
        if idx >= len(self.bounds):
            return 1.0  # objective beyond the last finite bound
        return sum(self.counts[: idx + 1]) / self.count

    def quantile(self, q: float) -> Optional[float]:
        """Histogram quantile: the upper bound of the bucket where the
        cumulative count first reaches ``q`` of the total (None when
        empty; the last finite bound stands in for +Inf)."""
        if self.count == 0:
            return None
        target = q / 100.0 * self.count if q > 1.0 else q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target and c:
                if i < len(self.bounds):
                    return self.bounds[i]
                return self.bounds[-1]
        return self.bounds[-1]


def slo_block(
    hist: Optional[LatencyHistogram],
    requests: Mapping[str, float],
    objective_ms: float,
    availability_target: float,
) -> dict:
    """The per-service SLO verdict, computed from the deterministic
    histogram plus the outcome counters.

    - ``availability`` — completed / (completed + shed + failed +
      deadline_exceeded); 1.0 with no finished requests.
    - ``latency_attainment`` — fraction of completed requests within
      the latency objective (histogram-resolved).
    - ``error_budget_burn`` — observed bad fraction (the worse of the
      two objectives) over the allowed fraction ``1 - target``; > 1.0
      means the budget is burning faster than it accrues.
    """
    completed = float(requests.get("completed", 0) or 0)
    bad = sum(
        float(requests.get(k, 0) or 0)
        for k in ("shed", "failed", "deadline_exceeded")
    )
    total = completed + bad
    availability = 1.0 if total == 0 else completed / total
    attainment = hist.attainment(objective_ms) if hist else 1.0
    budget = max(1e-9, 1.0 - float(availability_target))
    burn = (1.0 - min(availability, attainment)) / budget
    return {
        "objective_ms": float(objective_ms),
        "availability_target": float(availability_target),
        "availability": round(availability, 6),
        "latency_attainment": round(attainment, 6),
        "error_budget_burn": round(burn, 4),
        "ok": burn <= 1.0,
        "requests_observed": int(total),
    }
