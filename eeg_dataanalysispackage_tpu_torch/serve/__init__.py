"""Online inference serving for the P300 pipeline.

Port of the JAX package's ``serve/`` for single-model services:

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
- ``pipeline`` the ``serve=true`` query mode: drive a batch session
               through the service epoch by epoch, with the batch
               ``load_clf=`` run's statistics.

Not ported yet: ``lifecycle`` and ``multiplex`` (see ROADMAP.md).
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
from .engine import ServingEngine, windows_from_recording  # noqa: F401
from .service import InferenceService, ServeConfig  # noqa: F401
