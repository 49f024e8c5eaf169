"""Shared circuit breaker for remote endpoints.

Port of the JAX package's ``io/circuit.py``. The retry ladder of
``io/remote.py`` bounds the cost of one request against a flaky
endpoint, but a dead endpoint still charges that full budget to every
call. This is the three-state breaker, shared process-wide per endpoint
authority so every filesystem dialing the same gateway pools its
failure evidence:

- **closed** — requests flow; each exhausted retry budget increments a
  consecutive-failure count (any completed request resets it);
- **open** — after ``threshold`` consecutive exhausted budgets, calls
  fail fast with :class:`CircuitOpenError` carrying the evidence;
- **half-open** — after ``cooldown_s`` one probe call is let through;
  success closes the circuit, failure re-opens it and restarts the
  cooldown.

Transitions count ``circuit.opened``, ``circuit.closed``,
``circuit.fast_fail`` and ``circuit.probe`` in ``obs.metrics``.
``EEG_TPU_CIRCUIT_THRESHOLD`` and ``EEG_TPU_CIRCUIT_COOLDOWN`` configure
the shared breakers; a threshold of 0 disables breaking.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Deque, Dict, Optional, Tuple

from .. import obs
from ..obs import domain as run_domain
from ..obs import events

logger = logging.getLogger(__name__)

#: consecutive exhausted retry budgets before the circuit opens;
#: 0 disables the breaker
DEFAULT_THRESHOLD = 3
#: seconds the circuit stays open before a half-open probe is allowed
DEFAULT_COOLDOWN_S = 15.0
#: recent failure messages kept as evidence
_EVIDENCE_KEEP = 5

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitOpenError(IOError):
    """Fail-fast refusal: the endpoint's circuit is open.

    An ``IOError`` (like ``RemoteIOError``), so callers that treat remote
    failures as I/O errors handle it unchanged; the message carries the
    aggregated evidence.
    """


class CircuitBreaker:
    """Per-endpoint breaker; thread-safe. ``clock`` is injectable so
    tests drive the cooldown without sleeping."""

    def __init__(
        self,
        endpoint: str,
        threshold: int = DEFAULT_THRESHOLD,
        cooldown_s: float = DEFAULT_COOLDOWN_S,
        clock=time.monotonic,
    ):
        self.endpoint = endpoint
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._total_failures = 0
        self._opened_at: Optional[float] = None
        self._probe_in_flight = False
        self._evidence: Deque[str] = collections.deque(maxlen=_EVIDENCE_KEEP)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> None:
        """Gate one call: raises :class:`CircuitOpenError` when open
        (and not yet due for a probe); otherwise lets the call proceed,
        possibly as the half-open probe."""
        if self.threshold <= 0:
            return
        with self._lock:
            if self._state == CLOSED:
                return
            now = self._clock()
            if (self._state == OPEN and self._opened_at is not None
                    and now - self._opened_at >= self.cooldown_s):
                self._state = HALF_OPEN
            if self._state == HALF_OPEN and not self._probe_in_flight:
                # exactly one caller probes; the rest keep failing fast
                self._probe_in_flight = True
                obs.metrics.count("circuit.probe")
                logger.warning(
                    "circuit.transition endpoint=%s open->half_open probe=allowed "
                    "consecutive_failures=%d evidence=%s",
                    self.endpoint, self._consecutive_failures, list(self._evidence),
                )
                events.event("circuit.half_open", endpoint=self.endpoint,
                             consecutive_failures=self._consecutive_failures)
                return
            # a counter only, no event per fast-fail: an open-circuit
            # storm would evict the circuit.opened event from the ring
            obs.metrics.count("circuit.fast_fail")
            raise CircuitOpenError(
                f"circuit open for {self.endpoint}: "
                f"{self._total_failures} exhausted retry budgets "
                f"({self._consecutive_failures} consecutive), open for "
                f"{0.0 if self._opened_at is None else now - self._opened_at:.1f}s; "
                f"recent errors: {list(self._evidence)}"
            )

    def record_success(self) -> None:
        """A request completed (any response counts: the endpoint is
        alive); closes a half-open circuit."""
        if self.threshold <= 0:
            return
        with self._lock:
            was = self._state
            self._state = CLOSED
            self._consecutive_failures = 0
            self._probe_in_flight = False
            self._opened_at = None
            if was != CLOSED:
                obs.metrics.count("circuit.closed")
                logger.warning(
                    "circuit.transition endpoint=%s %s->closed (successful probe) "
                    "prior_failures=%d evidence=%s",
                    self.endpoint, was, self._total_failures, list(self._evidence),
                )
                events.event("circuit.closed", endpoint=self.endpoint,
                             prior_failures=self._total_failures)

    def snapshot(self) -> Dict[str, object]:
        """The breaker's state as report evidence: state, failure
        counts, the recent (plan-tagged) evidence and the plan ids that
        contributed it."""
        with self._lock:
            contributors = sorted({
                e.split("]", 1)[0][6:] for e in self._evidence if e.startswith("[plan ")
            })
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "total_failures": self._total_failures,
                "evidence": list(self._evidence),
                "contributing_plans": contributors,
            }

    def record_failure(self, error: Exception) -> None:
        """One exhausted retry budget against the endpoint.

        Breakers are process-wide per endpoint by design: one dead
        gateway must not charge every plan the full backoff ladder. Each
        evidence entry is tagged with the plan that contributed it, so a
        plan fast-failed by a breaker another plan opened can name the
        opener.
        """
        if self.threshold <= 0:
            return
        plan_id = run_domain.current_plan_id()
        tag = "" if plan_id is None else f"[plan {plan_id}] "
        with self._lock:
            self._consecutive_failures += 1
            self._total_failures += 1
            self._evidence.append(f"{tag}{type(error).__name__}: {error}")
            half_open_probe_failed = self._state == HALF_OPEN
            self._probe_in_flight = False
            if self._consecutive_failures >= self.threshold or half_open_probe_failed:
                if self._state != OPEN:
                    obs.metrics.count("circuit.opened")
                    logger.error(
                        "circuit.transition endpoint=%s %s->open consecutive_failures=%d "
                        "cooldown_s=%.0f evidence=%s",
                        self.endpoint, self._state, self._consecutive_failures,
                        self.cooldown_s, list(self._evidence),
                    )
                    events.event("circuit.opened", endpoint=self.endpoint,
                                 consecutive_failures=self._consecutive_failures,
                                 evidence=list(self._evidence))
                self._state = OPEN
                self._opened_at = self._clock()


_REGISTRY: Dict[str, CircuitBreaker] = {}
_REGISTRY_LOCK = threading.Lock()


def _env_config() -> Tuple[int, float]:
    try:
        threshold = int(os.environ.get("EEG_TPU_CIRCUIT_THRESHOLD", DEFAULT_THRESHOLD))
    except ValueError:
        threshold = DEFAULT_THRESHOLD
    try:
        cooldown = float(os.environ.get("EEG_TPU_CIRCUIT_COOLDOWN", DEFAULT_COOLDOWN_S))
    except ValueError:
        cooldown = DEFAULT_COOLDOWN_S
    return threshold, cooldown


def breaker_for(endpoint: str) -> CircuitBreaker:
    """The process-shared breaker for an endpoint authority (e.g.
    ``http://nn.example:9870``)."""
    with _REGISTRY_LOCK:
        breaker = _REGISTRY.get(endpoint)
        if breaker is None:
            threshold, cooldown = _env_config()
            breaker = CircuitBreaker(endpoint, threshold=threshold, cooldown_s=cooldown)
            _REGISTRY[endpoint] = breaker
        return breaker


def snapshot() -> Dict[str, Dict[str, object]]:
    """Every registered breaker's :meth:`CircuitBreaker.snapshot`, keyed
    by endpoint ({} when no remote endpoint was ever dialed)."""
    with _REGISTRY_LOCK:
        breakers = dict(_REGISTRY)
    return {endpoint: breaker.snapshot() for endpoint, breaker in breakers.items()}


def reset() -> None:
    """Drop all shared breakers."""
    with _REGISTRY_LOCK:
        _REGISTRY.clear()
