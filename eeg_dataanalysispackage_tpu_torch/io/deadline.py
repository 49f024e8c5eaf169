"""Per-call deadline budgets on the monotonic clock.

Port of the JAX package's ``io/deadline.py`` (:class:`Deadline` and
:class:`DeadlineExceededError`). The serving layer (``serve/``) gives
every request a bounded lifetime: a request admitted with a 2 s
deadline resolves — answer, shed, or deadline-exceeded with evidence —
within that budget, however many retries fire beneath it.
"""

from __future__ import annotations

import time


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

    def __repr__(self) -> str:
        return (
            f"Deadline(budget={self.budget_s:.3f}s, "
            f"remaining={self.remaining():.3f}s)"
        )
