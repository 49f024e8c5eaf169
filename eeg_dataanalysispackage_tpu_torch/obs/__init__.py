"""Observability for the port: stage timers, counters and gauges, span
telemetry, fault injection, run domains, run reports, profiler traces,
latency histograms and the SLO block.

:class:`Metrics` is the port of the JAX package's ``obs.Metrics``
(``obs/__init__.py:107-193``): process-wide counters and gauges with
JSON export. Subsystems count into the default sink :data:`metrics`
(``ingest.file_reads``, ``circuit.*``, ``chaos.fired.<point>``);
:meth:`Metrics.scope` gives one run its own numbers (the run bracket,
``scheduler/runtime.py``, opens one per run). :class:`StageTimer`
accumulates a run's stage seconds for its report. :func:`trace` wraps a
region in a ``torch.profiler`` trace (host and CUDA activity, exported
as a Chrome trace) and :func:`annotate` names a host region inside it:
``trace_path=<dir>`` runs the whole run under :func:`trace`.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator


class StageTimer:
    """Accumulates wall time per named stage: total, count, min and max
    (mean derives), the shape the run report embeds."""

    def __init__(self) -> None:
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._mins: Dict[str, float] = {}
        self._maxs: Dict[str, float] = {}
        self._lock = threading.Lock()

    def record(self, name: str, elapsed: float) -> None:
        """Add one finished stage of ``elapsed`` seconds."""
        with self._lock:
            self._totals[name] += elapsed
            self._counts[name] += 1
            self._mins[name] = min(self._mins.get(name, elapsed), elapsed)
            self._maxs[name] = max(self._maxs.get(name, elapsed), elapsed)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "seconds": self._totals[name],
                    "count": self._counts[name],
                    "min_s": self._mins.get(name, 0.0),
                    "max_s": self._maxs.get(name, 0.0),
                    "mean_s": self._totals[name] / max(1, self._counts[name]),
                }
                for name in self._totals
            }


class Metrics:
    """Counters and gauges with JSON export.

    :meth:`scope` registers a fresh child that receives a copy of every
    count and gauge while the ``with`` block is open, so a run gets its
    own numbers while the process-wide sink keeps accumulating.
    :meth:`reset` zeroes an instance outright.
    """

    def __init__(self) -> None:
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._scopes: list = []
        self._lock = threading.Lock()

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value
            scopes = list(self._scopes)
        for scope in scopes:
            scope.count(name, value)

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value
            scopes = list(self._scopes)
        for scope in scopes:
            scope.gauge(name, value)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {"counters": dict(self._counters), "gauges": dict(self._gauges)}

    def reset(self) -> None:
        """Zero all counters and gauges (active scopes are kept)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()

    @contextlib.contextmanager
    def scope(self) -> Iterator["Metrics"]:
        """A per-run child: every count and gauge recorded on this
        instance while the block is open is mirrored into the yielded
        fresh ``Metrics``."""
        child = Metrics()
        with self._lock:
            self._scopes.append(child)
        try:
            yield child
        finally:
            with self._lock:
                self._scopes.remove(child)

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)


#: the process-wide default sink
metrics = Metrics()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """A ``torch.profiler`` trace around the block: host activity, and
    CUDA kernel activity when a card is present, exported as one Chrome
    trace (``torch-trace-<pid>-<ms>.json``) under ``log_dir``, viewable in
    Perfetto or ``chrome://tracing``. Spans and :func:`annotate` regions
    appear in it by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"torch-trace-{os.getpid()}-{int(time.time() * 1000)}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named host region inside a profiler trace
    (``torch.profiler.record_function``)."""
    import torch

    with torch.profiler.record_function(name):
        yield
