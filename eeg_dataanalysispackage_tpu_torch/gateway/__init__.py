"""The networked plan service: an HTTP front door over the port's
:class:`~eeg_dataanalysispackage_tpu_torch.scheduler.PlanExecutor`.

Port of the JAX package's ``gateway/``:

- :mod:`gateway.server`: :class:`GatewayServer`, one stdlib
  ``ThreadingHTTPServer`` exposing the executor's contract (``POST /plans``,
  ``POST /predict`` over an attached ``serve.MultiplexedService``,
  ``GET /plans[/<id>[/report]]``, ``DELETE /plans/<id>``, ``/stats``,
  ``/metrics``, ``/healthz``, ``/readyz``), with the ``X-Idempotency-Key``,
  ``X-Plan-Deadline-S`` and ``X-Trace-Id`` headers; it runs
  ``recover()`` at start, and prefix dedup (``scheduler/dedup.py``) runs
  underneath;
- :mod:`gateway.fleet`: :class:`FleetReplica`, N gateways over one shared
  journal directory that lease-claim plans, so any replica accepts, any
  finishes, and a killed replica's plans complete on a survivor under
  their original ids; the device pool (``EEG_TPU_DEVICE_POOL``) and the pod
  assist attach there.

``python -m eeg_dataanalysispackage_tpu_torch.gateway`` serves from the
command line (``--device``, default ``cuda``; ``--fleet --replica-id`` for
a fleet member; SIGTERM drains).
"""

from .fleet import FleetReplica  # noqa: F401
from .server import GatewayServer  # noqa: F401
