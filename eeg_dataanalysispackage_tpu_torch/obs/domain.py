"""Per-plan fault domains: the ambient execution context of one plan.

Port of the JAX package's ``obs/domain.py``. A :class:`RunDomain` carries
what must be per plan, so that plans running at once (the executor's
workers, ``scheduler/executor.py``) never see each other's state: its
``plan_id`` (which tags circuit-breaker evidence), its own fault plan,
span recorder and ``obs.Metrics`` child. It is installed on the executing
thread with :func:`activate`; a worker thread the run starts (the parse
pool, the staging producer, the serving batcher and watchdog) takes it
over with :func:`capture` on the starting thread and :func:`adopt` in its
body. ``obs/chaos.py``, ``obs/events.py`` and the default metrics sink
(``obs.metrics``) resolve the domain first; outside any domain they
behave as before.

This module imports nothing else of the package (thread-local plumbing
only), so chaos and events can consult it without cycles.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator, Optional


class RunDomain:
    """The ambient per-plan context."""

    __slots__ = ("plan_id", "chaos", "recorder", "metrics")

    def __init__(
        self,
        plan_id: Optional[str] = None,
        chaos: Optional[Any] = None,
        recorder: Optional[Any] = None,
        metrics: Optional[Any] = None,
    ):
        self.plan_id = plan_id
        self.chaos = chaos
        self.recorder = recorder
        self.metrics = metrics


_TLS = threading.local()


def current() -> Optional[RunDomain]:
    """The calling thread's innermost active domain, or None."""
    stack = getattr(_TLS, "stack", None)
    if not stack:
        return None
    return stack[-1]


def current_plan_id() -> Optional[str]:
    """The active domain's plan id, or None — the tag circuit-breaker
    evidence uses to attribute a failure to its plan."""
    d = current()
    return None if d is None else d.plan_id


@contextlib.contextmanager
def activate(domain: Optional[RunDomain]) -> Iterator[Optional[RunDomain]]:
    """Install ``domain`` as the calling thread's ambient context for
    the block; nests (the innermost domain wins). ``None`` is a no-op."""
    if domain is None:
        yield None
        return
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = []
        _TLS.stack = stack
    stack.append(domain)
    try:
        yield domain
    finally:
        stack.pop()


def capture() -> Optional[RunDomain]:
    """The domain a to-be-started worker thread should adopt: the
    caller's current domain (None outside any). Call on the starting
    thread and wrap the worker's body in :func:`adopt`."""
    return current()


#: adoption is installation, under the name thread bodies read by
adopt = activate
