"""Structured span and event telemetry.

Port of the JAX package's ``obs/events.py`` (its span recorder with the
JSONL sink and the run-report summary, without the cross-replica trace
sink, which belongs to its replica fleet): hierarchical spans with ids,
parent ids, monotonic times and attributes, bounded retention, an
optional JSONL file of every finished span and event (``report=``
writes ``spans.jsonl`` beside ``run_report.json``), and a ring of recent
*events* (``remote.retry``, ``circuit.opened``, ``chaos.fired`` …) that
a crash report dumps. One
process-wide recorder is installed for the scope of a run
(:func:`recording`); the module-level :func:`span`, :func:`event` and
:func:`set_attr` are a thread-local read and a ``None`` check when none
is installed, so instrumented code pays nothing unless a run opted in.
Telemetry observes and never steers.

Every span runs inside ``torch.profiler.record_function`` while a
recorder is active, so host spans line up with device activity in a
``torch.profiler`` trace.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from . import domain as _domain

#: finished spans kept in memory per recorder; beyond this, spans are
#: only counted
DEFAULT_MAX_SPANS = 10_000
#: recent events retained in the ring
DEFAULT_RING_CAPACITY = 512
#: events attached per span before the span only counts them
_MAX_EVENTS_PER_SPAN = 64


class SpanRecorder:
    """Hierarchical span/event recorder for one run. Thread-safe.

    ``jsonl_path`` gets one JSON line per finished span and per event
    (``{"kind": "span"|"event", ...}``); a write failure drops the sink
    and keeps the in-memory record."""

    def __init__(
        self,
        name: str = "run",
        jsonl_path: Optional[str] = None,
        max_spans: int = DEFAULT_MAX_SPANS,
        ring_capacity: int = DEFAULT_RING_CAPACITY,
    ):
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._t0 = time.perf_counter()
        self.wall_start = time.time()
        self._jsonl_path = jsonl_path
        self._jsonl_file = None
        self._jsonl_failed = False
        self._jsonl_closed = False
        self._local = threading.local()
        self._spans: List[Dict[str, Any]] = []
        self.dropped_spans = 0
        self._max_spans = int(max_spans)
        self._ring: collections.deque = collections.deque(maxlen=int(ring_capacity))
        # the root span is open for the recorder's whole life and closed
        # by finish(); spans of threads with no open span parent onto it
        self.root: Dict[str, Any] = {
            "id": next(self._ids), "parent": None, "name": name, "start": 0.0,
            "end": None, "thread": threading.current_thread().name,
            "attrs": {}, "events": [],
        }

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _stack(self) -> List[Dict[str, Any]]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        return stack

    def current_span(self) -> Dict[str, Any]:
        stack = self._stack()
        return stack[-1] if stack else self.root

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Dict[str, Any]]:
        """Open a child of the calling thread's current span; it closes
        (and is retained) when the block exits, with ``error`` recorded
        if the block raised."""
        stack = self._stack()
        rec = {
            "id": next(self._ids), "parent": self.current_span()["id"], "name": name,
            "start": self._now(), "end": None,
            "thread": threading.current_thread().name, "attrs": dict(attrs), "events": [],
        }
        stack.append(rec)
        try:
            with _annotation(name):
                yield rec
        except BaseException as e:
            rec["attrs"]["error"] = f"{type(e).__name__}: {e}"
            raise
        finally:
            rec["end"] = self._now()
            stack.pop()
            with self._lock:
                if len(self._spans) < self._max_spans:
                    self._spans.append(rec)
                else:
                    self.dropped_spans += 1
            self._sink({"kind": "span", **_span_line(rec)})

    def event(self, name: str, **attrs: Any) -> None:
        """Point-in-time mark on the current span; retained in the ring."""
        span = self.current_span()
        rec = {"t": self._now(), "span": span["id"], "span_name": span["name"],
               "name": name, "attrs": dict(attrs)}
        with self._lock:
            self._ring.append(rec)
            if len(span["events"]) < _MAX_EVENTS_PER_SPAN:
                span["events"].append(rec)
        self._sink({"kind": "event", **rec})

    def set_attr(self, name: str, value: Any) -> None:
        """Attach an attribute to the calling thread's current span."""
        self.current_span()["attrs"][name] = value

    def finish(self) -> None:
        """Close the root span and the JSONL sink (a straggler thread
        finishing a span later does not reopen it)."""
        if self.root["end"] is None:
            self.root["end"] = self._now()
            self._sink({"kind": "span", **_span_line(self.root)})
        with self._lock:
            self._jsonl_closed = True
            if self._jsonl_file is not None:
                try:
                    self._jsonl_file.close()
                except OSError:
                    pass
                self._jsonl_file = None

    def spans(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._spans)

    def recent_events(self) -> List[Dict[str, Any]]:
        """The event ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def summary(self) -> Dict[str, Any]:
        """The run report's view: per span name its count, total, min
        and max seconds, and the retention accounting."""
        by_name: Dict[str, Dict[str, float]] = {}
        with self._lock:
            spans = list(self._spans)
            dropped = self.dropped_spans
        for s in spans:
            dur = (s["end"] if s["end"] is not None else self._now()) - s["start"]
            agg = by_name.setdefault(
                s["name"], {"count": 0, "seconds": 0.0, "min_s": dur, "max_s": dur})
            agg["count"] += 1
            agg["seconds"] += dur
            agg["min_s"] = min(agg["min_s"], dur)
            agg["max_s"] = max(agg["max_s"], dur)
        for agg in by_name.values():
            for k in ("seconds", "min_s", "max_s"):
                agg[k] = round(agg[k], 6)
        return {
            "root": self.root["name"],
            "wall_start": self.wall_start,
            "span_count": len(spans) + dropped + 1,
            "dropped_spans": dropped,
            "by_name": dict(sorted(by_name.items())),
        }

    def _sink(self, line: Dict[str, Any]) -> None:
        if self._jsonl_path is None or self._jsonl_failed:
            return
        with self._lock:
            if self._jsonl_closed:
                return
            try:
                if self._jsonl_file is None:
                    # one recorder is one run is one file: a rerun into
                    # the same report directory replaces it
                    self._jsonl_file = open(self._jsonl_path, "w")
                self._jsonl_file.write(json.dumps(line, sort_keys=True, default=str) + "\n")
                self._jsonl_file.flush()
            except OSError:
                # a broken sink never fails the run it observes
                self._jsonl_failed = True
                self._jsonl_file = None


def _span_line(rec: Dict[str, Any]) -> Dict[str, Any]:
    out = {k: rec[k] for k in ("id", "parent", "name", "start", "end", "thread", "attrs")}
    out["events"] = len(rec["events"])
    return out


@contextlib.contextmanager
def _annotation(name: str) -> Iterator[None]:
    """``torch.profiler.record_function`` alongside the span."""
    import torch

    with torch.profiler.record_function(name):
        yield


_RECORDER: Optional[SpanRecorder] = None


def active_recorder() -> Optional[SpanRecorder]:
    """The recorder observing the calling thread: its run domain's
    recorder when it has one, else the process-wide installation."""
    d = _domain.current()
    if d is not None and d.recorder is not None:
        return d.recorder
    return _RECORDER


@contextlib.contextmanager
def recording(recorder: SpanRecorder) -> Iterator[SpanRecorder]:
    """Install ``recorder`` process-wide for the block; restores the
    recorder active before and finishes this one."""
    global _RECORDER
    previous = _RECORDER
    _RECORDER = recorder
    try:
        yield recorder
    finally:
        _RECORDER = previous
        recorder.finish()


@contextlib.contextmanager
def span(name: str, **attrs: Any) -> Iterator[Optional[Dict[str, Any]]]:
    """Module-level span; yields the live span record, or None when no
    recorder is active."""
    rec = active_recorder()
    if rec is None:
        yield None
        return
    with rec.span(name, **attrs) as s:
        yield s


def event(name: str, **attrs: Any) -> None:
    """Module-level event; no-op without a recorder."""
    rec = active_recorder()
    if rec is not None:
        rec.event(name, **attrs)


def set_attr(name: str, value: Any) -> None:
    """Attach an attribute to the current span; no-op without a recorder."""
    rec = active_recorder()
    if rec is not None:
        rec.set_attr(name, value)
