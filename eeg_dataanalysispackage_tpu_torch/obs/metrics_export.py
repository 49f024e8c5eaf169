"""Deterministic fixed-bucket latency histograms, the SLO block and the
Prometheus text exposition.

Port of the JAX package's ``obs/metrics_export.py``:
:class:`LatencyHistogram` (``serve/batcher.py`` observes every completed
request into one) with :func:`merge_all`, :func:`slo_block`
(``serve/service.py``'s stats block), and the text format the gateway's
``GET /metrics`` serves: :func:`render` (``*_total`` counters, gauges,
``*_bucket``/``*_sum``/``*_count`` histogram series and a
``<prefix>_build_info`` series, sorted by name and label set, so two
renders of one state are byte-equal, and byte-equal to the JAX
package's), and its scrape half :func:`parse` with
:func:`histogram_from_series`. Fixed buckets and integer counts, so two
histograms merge by exact integer addition. Stdlib only.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

#: Shared latency bucket upper bounds, milliseconds. The +Inf bucket is
#: implicit (``counts`` carries one extra slot).
BUCKET_BOUNDS_MS: Tuple[float, ...] = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0,
)

#: Prometheus content type for the /metrics endpoint.
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


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


def merge_all(
    hists: Iterable[LatencyHistogram],
) -> Optional[LatencyHistogram]:
    """Merge an iterable of histograms into a fresh one (None when
    empty) — the fleet aggregator's reduce step."""
    out: Optional[LatencyHistogram] = None
    for h in hists:
        if out is None:
            out = LatencyHistogram(h.bounds)
        out.merge(h)
    return out


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


# -- Prometheus text exposition ---------------------------------------

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def metric_name(name: str, prefix: str = "eeg_tpu") -> str:
    """Counter/gauge name -> a legal Prometheus metric name
    (``scheduler.completed`` -> ``eeg_tpu_scheduler_completed``)."""
    base = _NAME_BAD.sub("_", name.strip())
    full = f"{prefix}_{base}" if prefix else base
    if full and full[0].isdigit():
        full = "_" + full
    return full


def escape_label_value(value: str) -> str:
    """Label-value escaping per the exposition format: backslash,
    double quote, newline."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt(value: float) -> str:
    """Deterministic number rendering: integers without a fractional
    part, floats via repr (shortest round-trip)."""
    f = float(value)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def render(
    counters: Optional[Mapping[str, float]] = None,
    histograms: Optional[
        Sequence[Tuple[str, Mapping[str, str], LatencyHistogram]]
    ] = None,
    gauges: Optional[Mapping[str, float]] = None,
    info: Optional[Mapping[str, str]] = None,
    prefix: str = "eeg_tpu",
) -> str:
    """Render one deterministic exposition document.

    ``counters`` maps dotted names to values (``*_total`` series);
    ``histograms`` is a sequence of (dotted name, labels, histogram);
    ``info`` becomes a ``<prefix>_build_info`` gauge with the mapping
    as labels (the replica-identity series). Output is sorted by
    (metric name, label set) and ends with a newline.
    """
    out: List[str] = []
    if info:
        name = metric_name("build_info", prefix)
        out.append(f"# TYPE {name} gauge")
        out.append(f"{name}{_labels({k: str(v) for k, v in info.items()})} 1")
    for raw in sorted(counters or {}):
        name = metric_name(raw, prefix) + "_total"
        out.append(f"# TYPE {name} counter")
        out.append(f"{name} {_fmt((counters or {})[raw])}")
    for raw in sorted(gauges or {}):
        name = metric_name(raw, prefix)
        out.append(f"# TYPE {name} gauge")
        out.append(f"{name} {_fmt((gauges or {})[raw])}")
    seen_types = set()
    for raw, labels, hist in sorted(
        histograms or (),
        key=lambda t: (t[0], sorted((t[1] or {}).items())),
    ):
        name = metric_name(raw, prefix)
        if name not in seen_types:
            seen_types.add(name)
            out.append(f"# TYPE {name} histogram")
        base = dict(labels or {})
        cum = 0
        for i, bound in enumerate(hist.bounds):
            cum += hist.counts[i]
            le = {**base, "le": _fmt(bound)}
            out.append(f"{name}_bucket{_labels(le)} {cum}")
        cum += hist.counts[-1]
        out.append(f"{name}_bucket{_labels({**base, 'le': '+Inf'})} {cum}")
        out.append(f"{name}_sum{_labels(base)} {_fmt(round(hist.sum_ms, 3))}")
        out.append(f"{name}_count{_labels(base)} {hist.count}")
    return "\n".join(out) + "\n"


# -- scrape-side parser (fleet_top, bench assertions) ------------------

_SERIES = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$"
)
_LABEL = re.compile(r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:\\.|[^"\\])*)"')


def _unescape(value: str) -> str:
    return (
        value.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")
    )


def parse(text: str) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """Parse an exposition document back into
    ``{metric_name: [(labels, value), ...]}`` — the scrape half of the
    round trip ``fleet_top`` and the bench assertions use. Comment and
    blank lines are skipped; +Inf parses to ``float('inf')``."""
    series: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SERIES.match(line)
        if not m:
            continue
        labels = {
            lm.group("k"): _unescape(lm.group("v"))
            for lm in _LABEL.finditer(m.group("labels") or "")
        }
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        series.setdefault(m.group("name"), []).append((labels, value))
    return series


def histogram_from_series(
    series: Dict[str, List[Tuple[Dict[str, str], float]]],
    name: str,
    match: Optional[Mapping[str, str]] = None,
) -> Optional[LatencyHistogram]:
    """Rebuild a :class:`LatencyHistogram` from parsed ``_bucket`` /
    ``_sum`` / ``_count`` series (optionally narrowed to label values
    in ``match``) — exact, because the buckets are fixed and integer."""
    want = dict(match or {})

    def keep(labels: Dict[str, str]) -> bool:
        return all(labels.get(k) == v for k, v in want.items())

    buckets = [
        (labels, v)
        for labels, v in series.get(name + "_bucket", [])
        if keep(labels)
    ]
    if not buckets:
        return None
    finite = sorted(
        {
            float(labels["le"])
            for labels, _ in buckets
            if labels.get("le") not in (None, "+Inf")
        }
    )
    hist = LatencyHistogram(finite or BUCKET_BOUNDS_MS)
    cum = {}
    for labels, v in buckets:
        le = labels.get("le")
        cum[float("inf") if le == "+Inf" else float(le)] = int(v)
    prev = 0
    for i, bound in enumerate(hist.bounds):
        c = cum.get(bound, prev)
        hist.counts[i] = c - prev
        prev = c
    hist.counts[-1] = cum.get(float("inf"), prev) - prev
    hist.count = sum(hist.counts)
    for labels, v in series.get(name + "_sum", []):
        if keep(labels):
            hist.sum_us = int(round(float(v) * 1000.0))
            break
    return hist
