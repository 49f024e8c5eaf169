"""Observability for the port: stage timers, counters and gauges, span
telemetry, fault injection, run domains, run reports, profiler traces,
latency histograms and the SLO block.

:class:`Metrics` is the port of the JAX package's ``obs.Metrics``
(``obs/__init__.py:107-193``): process-wide counters and gauges with
JSON export. Subsystems count into the default sink :data:`metrics`
(``ingest.file_reads``, ``circuit.*``, ``chaos.fired.<point>``), which
also routes each count and gauge into the active run domain's child
(``obs/domain.py``): the run bracket (``scheduler/runtime.py``) gives each
plan its own, so two plans running at once never count into each other's
numbers. :meth:`Metrics.scope` mirrors every count into a child while it
is open, whichever plan made it. :class:`StageTimer`
accumulates a run's stage seconds for its report. :func:`trace` wraps a
region in a ``torch.profiler`` trace (host and CUDA activity, exported
as a Chrome trace) and :func:`annotate` names a host region inside it:
``trace_path=<dir>`` runs the whole run under :func:`trace`.
:func:`save_memory_profile` pickles the CUDA caching allocator's snapshot,
and :func:`configure_logging` sets up console and daily-rolling file
logging, the file named by ``LOGFILE_NAME`` (the reference's
``-Dlogfile.name``, log4j.xml:23-31).
"""

from __future__ import annotations

import contextlib
import json
import logging
import logging.handlers
import os
import pickle
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

from . import domain as _domain


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

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        """Time the block as one ``name`` stage (recorded if it raises too)."""
        start = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - start)

    def total(self, name: str) -> float:
        """A stage's seconds so far; 0.0 for a stage never recorded."""
        return self._totals.get(name, 0.0)

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

    def report(self) -> str:
        """The stages as an aligned table, slowest first (ties by name)."""
        rows = sorted(self.as_dict().items(), key=lambda kv: (-kv[1]["seconds"], kv[0]))
        width = max((len(n) for n, _ in rows), default=5)
        cwidth = max((len(str(v["count"])) for _, v in rows), default=1)
        return "\n".join(
            f"{name:<{width}}  {v['seconds']:9.4f}s  x{v['count']:<{cwidth}}  "
            f"mean {v['mean_s']:9.4f}s  min {v['min_s']:9.4f}s  max {v['max_s']:9.4f}s"
            for name, v in rows
        )


class Metrics:
    """Counters and gauges with JSON export.

    :meth:`scope` registers a fresh child that receives a copy of every
    count and gauge while the ``with`` block is open, whichever thread
    made it. The default sink :data:`metrics` alone also routes each
    count and gauge into the active run domain's child, so a plan's own
    numbers stay its own when plans run at once. :meth:`reset` zeroes an
    instance outright.
    """

    def __init__(self) -> None:
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._scopes: list = []
        self._lock = threading.Lock()
        #: set on the default sink only: a domain's child (or any other
        #: private instance) must not route again, which would count twice
        self._route_domains = False

    def _domain_child(self):
        if not self._route_domains:
            return None
        d = _domain.current()
        return None if d is None else d.metrics

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value
            scopes = list(self._scopes)
        for scope in scopes:
            scope.count(name, value)
        child = self._domain_child()
        if child is not None:
            child.count(name, value)

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value
            scopes = list(self._scopes)
        for scope in scopes:
            scope.gauge(name, value)
        child = self._domain_child()
        if child is not None:
            child.gauge(name, value)

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
metrics._route_domains = True


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


def save_memory_profile(path: str) -> bool:
    """Write the CUDA caching allocator's snapshot
    (``torch.cuda.memory_snapshot()``: a list of segment dicts with their
    blocks, sizes and states) to ``path`` as a pickle; returns True. With
    no CUDA allocator (no card) it logs and returns False, as the JAX
    package's function does where its backend has no memory profiling:
    best-effort observability, never a failure of the caller."""
    import torch

    log = logging.getLogger(__name__)
    if not torch.cuda.is_available():
        log.warning("device memory profile unavailable (%s): no CUDA device", path)
        return False
    try:
        snapshot = torch.cuda.memory_snapshot()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(snapshot, f)
        return True
    except Exception as e:
        log.warning("device memory profile unavailable (%s): %s", path, e)
        return False


def configure_logging(level: int = logging.INFO, logfile: Optional[str] = None) -> None:
    """Console and, with ``logfile`` (default: the ``LOGFILE_NAME``
    environment variable), daily-rolling file logging (seven files kept),
    in the JAX package's format."""
    handlers: list = [logging.StreamHandler()]
    logfile = logfile or os.environ.get("LOGFILE_NAME")
    if logfile:
        os.makedirs(os.path.dirname(logfile) or ".", exist_ok=True)
        handlers.append(logging.handlers.TimedRotatingFileHandler(
            logfile, when="midnight", backupCount=7))
    logging.basicConfig(
        level=level,
        format="%(asctime)s.%(msecs)03d %(levelname)s %(name)s - %(message)s",
        datefmt="%H:%M:%S",
        handlers=handlers,
        force=True,
    )
