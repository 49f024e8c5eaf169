"""Observability for the port: counters and gauges, span telemetry,
fault injection, run domains, latency histograms and the SLO block.

:class:`Metrics` is the port of the JAX package's ``obs.Metrics``
(``obs/__init__.py:107-193``): process-wide counters and gauges with
JSON export. Subsystems count into the default sink :data:`metrics`
(``ingest.file_reads``, ``circuit.*``, ``chaos.fired.<point>``);
:meth:`Metrics.scope` gives one run its own numbers (the JAX package's
routing into a plan's run domain comes with its scheduler).
"""

from __future__ import annotations

import contextlib
import json
import threading
from collections import defaultdict
from typing import Dict, Iterator


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
