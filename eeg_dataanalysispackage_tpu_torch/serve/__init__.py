"""Online inference serving for the P300 pipeline.

Port of the JAX package's ``serve/``:

- ``engine``   the serving engine: raw epoch-window bytes -> margins
               through the serve megakernel (``csrc/serve_mega.cu``),
               or the fused ingest kernel plus a matvec;
- ``batcher``  the micro-batching front end: bounded admission queue
               with explicit load shedding, per-request deadlines and
               deadline-aware retries, a watchdog that fails requests
               fast when the batcher wedges, graceful drain;
- ``service``  the resident wrapper (:class:`InferenceService`):
               load a saved classifier once, serve until drained,
               export the ``serve`` stats block;
- ``multiplex`` many tenants' linear models behind one engine
               (:class:`MultiplexedService`): a tenant-major weight
               stack, the tenant-stacked megakernel, admin that builds
               nothing, per-tenant quotas and attribution (f32 stack);
- ``lifecycle`` the model lifecycle of a solo service (``adapt=``):
               streaming partial fit on labeled feedback featurized by
               the engine's own kernel, shadow-scored hot swap with
               rollback, drift detection, resumable candidate
               checkpoints;
- ``pipeline`` the ``serve=true`` query mode: drive a batch session
               through the service epoch by epoch, with the batch
               ``load_clf=`` run's statistics; the tenant spec loaders.
"""

from .batcher import (  # noqa: F401
    RequestFailedError,
    Result,
    ServeError,
    ServeFuture,
    ServiceClosedError,
    ServiceWedgedError,
    ShedError,
)
from . import lifecycle  # noqa: F401
from .engine import ServingEngine, windows_from_recording  # noqa: F401
from .lifecycle import LifecycleConfig, LifecycleManager  # noqa: F401
from .multiplex import MultiplexedEngine, MultiplexedService, TenantStack  # noqa: F401
from .service import InferenceService, ServeConfig  # noqa: F401
