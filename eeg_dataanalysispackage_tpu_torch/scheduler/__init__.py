"""Plan scheduling: the execution half of the ``pipeline/plan.ExecutionPlan``
IR (ports of the JAX package's modules of the same names).

- :mod:`scheduler.runtime`: ``execute_plan``, one plan in its own fault
  domain (fault plan, span recorder, metrics child, run report);
- :mod:`scheduler.journal`: the write-ahead plan journal that makes the
  executor crash-only;
- :mod:`scheduler.executor`: the resident :class:`PlanExecutor` (bounded
  admission with shed-with-evidence, N worker threads, per-plan deadlines
  and retry budgets, idempotency-keyed submission, cancel-if-queued,
  :meth:`PlanExecutor.recover`);
- :mod:`scheduler.lease`: the cross-process plan claim (``plan-<id>.lease``
  beside the journal records), so executors over one journal directory run
  each plan exactly once.

The JAX package's prefix dedup and device placement (``scheduler/dedup``,
``scheduler/placement``) and its gateway are not ported yet (ROADMAP A9.3-
A9.5).
"""

from .executor import (  # noqa: F401
    IdempotencyConflictError,
    PlanCancelledError,
    PlanExecutor,
    PlanFailedError,
    PlanHandle,
    PlanOwnedElsewhereError,
    PlanResult,
    PlanShedError,
)
from .journal import PlanJournal  # noqa: F401
from .lease import LeaseDir, PlanLease  # noqa: F401
from .runtime import execute_plan  # noqa: F401
