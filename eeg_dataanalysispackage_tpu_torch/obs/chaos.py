"""Deterministic fault injection: a seedable fault plan.

Port of the JAX package's ``obs/chaos.py``. Named injection points fire
deterministically from a parsed fault plan, so the retry and circuit
machinery is provable: a run under a fixed spec and seed replays the
same firings at the same calls as the JAX package does.

Spec grammar::

    spec      := entry (';' entry)*
    entry     := 'seed=' int              -- plan seed (default 0)
               | point ':' directive
    directive := 'p=' float               -- fire each call with prob. p
                                             (seeded; deterministic)
               | 'once@' n | 'err@' n     -- fire once, on the n-th call
               | 'every@' n               -- fire on every n-th call

The port fires ``remote.request`` (one HTTP request attempt in
``io/remote.py``; it raises a retryable ``RemoteIOError``),
``serve.adapt`` (one partial-fit chunk of the serving lifecycle),
``serve.swap`` (one promotion attempt; both in ``serve/lifecycle.py``),
``device.step`` (one chunk of an elastic training run:
``models/sgd.train_linear_elastic`` and the network's ``fit_elastic``),
``serve.request`` (one admitted request), ``serve.batch`` (one
micro-batch execution) and ``serve.batch.tenant.<name>`` (one tenant's
rows of a mixed batch; all three in ``serve/batcher.py``, where the
batcher's retries take them), ``ingest.fused`` (one
``load_features_device`` call in ``io/provider.py``; the port has no
degradation ladder, so it fails the run), ``staging.producer`` (one
item staged by ``io/staging.prefetch``'s producer thread: under
``overlap=true`` one recording's featurize, which fails the run for the
same reason), ``scheduler.plan`` (one run, in the run bracket
``scheduler/runtime.py``; the executor's retry budget absorbs it),
``scheduler.journal`` (one journal record write,
``scheduler/journal.py``: retried once, then the plan runs unjournaled,
counted), ``fleet.lease`` (one lease claim attempt) and
``fleet.heartbeat`` (one heartbeat; both in ``scheduler/lease.py``,
raised as ``OSError``: a failed claim is no claim, a failed beat a
skipped one, both counted). These are all the JAX package's points. A
spec that names a point with no injection site raises
:class:`FaultSpecError` here rather than parse and never fire. A run's ``faults=`` query key
(or ``EEG_TPU_FAULTS``, :func:`plan_from_env`) installs its plan in
the run's domain; :func:`faults` installs one process-wide.

:func:`maybe_fire` with no plan installed is one thread-local read and
a global ``None`` check. A firing counts ``chaos.fired.<point>`` in
``obs.metrics`` and raises the exception type the site passes.
"""

from __future__ import annotations

import logging
import os
import random
import re
import threading
from contextlib import contextmanager
from typing import Dict, Iterator, Optional

from . import domain as _domain

logger = logging.getLogger(__name__)

#: the points the port has an injection site for
PORTED_POINTS = (
    "remote.request", "serve.adapt", "serve.swap", "device.step",
    "serve.request", "serve.batch", "ingest.fused", "staging.producer", "scheduler.plan",
    "scheduler.journal", "fleet.lease", "fleet.heartbeat",
)
#: the per-tenant batch point, ``serve.batch.tenant.<name>``
TENANT_BATCH_PREFIX = "serve.batch.tenant."
#: a run's fault spec when its query has no ``faults=``
ENV_SPEC = "EEG_TPU_FAULTS"


def _is_ported(point: str) -> bool:
    return point in PORTED_POINTS or (
        point.startswith(TENANT_BATCH_PREFIX) and len(point) > len(TENANT_BATCH_PREFIX))


class ChaosInjectedError(RuntimeError):
    """The default exception raised by a firing injection point."""


class FaultSpecError(ValueError):
    """A fault spec string does not parse."""


_DIRECTIVE_RE = re.compile(
    r"^(?:p=(?P<p>[0-9.eE+-]+)|(?P<mode>once|err|every)@(?P<n>\d+))$"
)


class FaultRule:
    """One ``point:directive`` entry; the plan's lock guards its counts."""

    def __init__(self, point: str, mode: str, value: float):
        self.point = point
        self.mode = mode  # "p" | "once" | "every"
        self.value = value
        self.calls = 0
        self.fired = 0

    def should_fire(self, seed: int) -> bool:
        self.calls += 1
        if self.mode == "p":
            # seeded per (seed, point, call): the same spec and seed
            # replay the same firings in any process
            hit = random.Random(f"{seed}:{self.point}:{self.calls}").random() < self.value
        elif self.mode == "once":
            hit = self.calls == int(self.value)
        else:  # every
            hit = self.calls % int(self.value) == 0
        if hit:
            self.fired += 1
        return hit

    def __repr__(self) -> str:
        tag = {"p": f"p={self.value}", "once": f"once@{int(self.value)}",
               "every": f"every@{int(self.value)}"}[self.mode]
        return f"FaultRule({self.point}:{tag}, calls={self.calls}, fired={self.fired})"


class FaultPlan:
    """A parsed spec: rules keyed by injection point, plus the seed."""

    def __init__(self, rules: Dict[str, FaultRule], seed: int = 0, spec: str = ""):
        self.rules = rules
        self.seed = seed
        self.spec = spec
        self._lock = threading.Lock()

    def should_fire(self, point: str) -> bool:
        rule = self.rules.get(point)
        if rule is None:
            return False
        with self._lock:
            return rule.should_fire(self.seed)

    def __repr__(self) -> str:
        return f"FaultPlan(seed={self.seed}, {list(self.rules.values())})"


def parse_fault_spec(spec: str, seed: int = 0) -> FaultPlan:
    """Spec string -> :class:`FaultPlan` (see the module grammar)."""
    rules: Dict[str, FaultRule] = {}
    for raw in spec.split(";"):
        entry = raw.strip()
        if not entry:
            continue
        if entry.startswith("seed="):
            try:
                seed = int(entry[len("seed="):])
            except ValueError as e:
                raise FaultSpecError(f"bad seed in {entry!r}") from e
            continue
        point, sep, directive = entry.partition(":")
        point = point.strip()
        if not sep or not point:
            raise FaultSpecError(
                f"fault entry {entry!r} is not 'point:directive' "
                f"(e.g. 'remote.request:p=0.2')"
            )
        if not _is_ported(point):
            raise FaultSpecError(
                f"fault point {point!r} has no injection site (the port injects "
                f"at {', '.join(PORTED_POINTS)} and {TENANT_BATCH_PREFIX}<name>)"
            )
        m = _DIRECTIVE_RE.match(directive.strip())
        if m is None:
            raise FaultSpecError(
                f"bad directive {directive!r} for point {point!r}; "
                f"expected p=<float>, once@<n>, err@<n>, or every@<n>"
            )
        if m.group("p") is not None:
            try:
                p = float(m.group("p"))
            except ValueError as e:
                raise FaultSpecError(f"bad probability in {entry!r}") from e
            if not 0.0 <= p <= 1.0:
                raise FaultSpecError(f"probability {p} out of [0, 1] in {entry!r}")
            rule = FaultRule(point, "p", p)
        else:
            n = int(m.group("n"))
            if n < 1:
                raise FaultSpecError(f"call index must be >= 1 in {entry!r}")
            mode = "every" if m.group("mode") == "every" else "once"
            rule = FaultRule(point, mode, float(n))
        rules[rule.point] = rule
    return FaultPlan(rules, seed=seed, spec=spec)


#: the process-wide active plan; None = chaos off
_PLAN: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    """The fault plan governing the calling thread: its run domain's
    plan when it carries one, else the process-wide installation."""
    d = _domain.current()
    if d is not None and d.chaos is not None:
        return d.chaos
    return _PLAN


def install(spec_or_plan, seed: int = 0) -> FaultPlan:
    """Activate a fault plan process-wide; returns it."""
    global _PLAN
    plan = (spec_or_plan if isinstance(spec_or_plan, FaultPlan)
            else parse_fault_spec(spec_or_plan, seed=seed))
    _PLAN = plan
    logger.warning("chaos fault plan installed: %r", plan)
    return plan


def uninstall() -> None:
    global _PLAN
    _PLAN = None


@contextmanager
def faults(spec: str, seed: int = 0) -> Iterator[FaultPlan]:
    """Scoped installation; restores the plan active before."""
    global _PLAN
    previous = _PLAN
    plan = install(spec, seed=seed)
    try:
        yield plan
    finally:
        _PLAN = previous


def plan_from_env() -> Optional[str]:
    """The ``EEG_TPU_FAULTS`` spec string, or None when unset or empty."""
    return os.environ.get(ENV_SPEC) or None


def maybe_fire(point: str, exc_type: type = ChaosInjectedError) -> None:
    """The injection-point call: returns at once with no plan; when the
    plan's rule for ``point`` fires, counts ``chaos.fired.<point>`` in
    ``obs.metrics``, records a ``chaos.fired`` event and raises
    ``exc_type``."""
    plan = active_plan()
    if plan is None:
        return
    if plan.should_fire(point):
        from .. import obs
        from . import events

        rule = plan.rules[point]
        obs.metrics.count(f"chaos.fired.{point}")
        events.event("chaos.fired", point=point, call=rule.calls, firing=rule.fired)
        logger.warning("chaos: firing %s (call %d, firing %d)", point, rule.calls, rule.fired)
        raise exc_type(f"chaos: injected fault at {point} (call {rule.calls})")
