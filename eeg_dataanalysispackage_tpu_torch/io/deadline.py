"""Per-call deadline budgets, threadable through nested I/O layers.

Port of the JAX package's ``io/deadline.py``. The serving layer
(``serve/``) gives every request a bounded lifetime: a request admitted
with a 2 s deadline resolves — answer, shed, or deadline-exceeded with
evidence — within that budget, however many retries fire beneath it.
The retry ladder of ``io/remote.py`` bounds one request's cost but
sleeps through its backoff blind to the caller's budget; the
thread-local ambient scope here lets a layer that never heard of
serving (an HTTP chunk fetch three frames down) ask "can I afford this
sleep?" before taking it. Scopes nest, and an inner scope may only
shrink the budget: the tightest enclosing deadline governs.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, Optional


class DeadlineExceededError(TimeoutError):
    """The caller's deadline budget is spent.

    Subclasses ``TimeoutError`` (an ``OSError``), so I/O layers that
    already treat timeouts as I/O failures handle it unchanged.
    """


class Deadline:
    """An absolute expiry on the monotonic clock.

    ``clock`` is injectable so tests drive expiry without sleeping.
    """

    __slots__ = ("_expiry", "_clock", "budget_s")

    def __init__(self, budget_s: float, clock=time.monotonic):
        self.budget_s = float(budget_s)
        self._clock = clock
        self._expiry = clock() + float(budget_s)

    def remaining(self) -> float:
        """Seconds left; never negative."""
        return max(0.0, self._expiry - self._clock())

    @property
    def expired(self) -> bool:
        return self._clock() >= self._expiry

    def can_cover(self, seconds: float) -> bool:
        """Whether the remaining budget covers ``seconds`` of work —
        the question a retry loop asks before committing to a backoff
        sleep it could never wake from in time."""
        return self.remaining() >= seconds

    def raise_if_expired(self, what: str = "operation") -> None:
        if self.expired:
            raise DeadlineExceededError(
                f"{what}: deadline exceeded (budget {self.budget_s:.3f}s spent)"
            )

    def __repr__(self) -> str:
        return (
            f"Deadline(budget={self.budget_s:.3f}s, "
            f"remaining={self.remaining():.3f}s)"
        )


def cond_wait(cond: threading.Condition, predicate, what: str,
              slice_s: float = 0.1) -> None:
    """Wait on ``cond`` (whose lock the caller holds) until
    ``predicate()`` is true, honouring the ambient deadline scope:
    outside any scope a plain ``cond.wait()`` loop; inside one, the
    wait re-checks in short slices and raises
    :class:`DeadlineExceededError` the moment the budget is spent."""
    while not predicate():
        ambient = active_deadline()
        if ambient is None:
            cond.wait()
        else:
            ambient.raise_if_expired(what)
            cond.wait(timeout=min(slice_s, ambient.remaining()))


_LOCAL = threading.local()


def active_deadline() -> Optional[Deadline]:
    """The calling thread's tightest enclosing deadline, or None."""
    stack = getattr(_LOCAL, "stack", None)
    if not stack:
        return None
    # nesting only shrinks: the earliest-expiring enclosing deadline
    # governs, whatever order the scopes were opened in
    return min(stack, key=lambda d: d.remaining())


@contextlib.contextmanager
def deadline_scope(deadline: Optional[Deadline]) -> Iterator[Optional[Deadline]]:
    """Install ``deadline`` as the calling thread's ambient budget for
    the block. ``None`` is a no-op, so call sites can thread an
    optional deadline without branching."""
    if deadline is None:
        yield None
        return
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = []
        _LOCAL.stack = stack
    stack.append(deadline)
    try:
        yield deadline
    finally:
        stack.pop()
