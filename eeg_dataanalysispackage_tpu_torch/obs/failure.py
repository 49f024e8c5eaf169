"""Failure detection and elastic recovery for training runs.

Port of the JAX package's ``obs/failure.py``, layered on the atomic
checkpoint store (``checkpoint/manager.py``):

- :func:`probe_devices`: one tiny operation on every CUDA device (or the
  CPU, trivially healthy) under a deadline, on worker threads, so a
  wedged device cannot hang the probe; a device that raises, answers
  late or computes a wrong sum is reported failed;
- :class:`DivergenceSentinel`: a loss-stream detector; a non-finite loss,
  or one above ``explode_factor`` times the rolling median for
  ``patience`` steps, raises :class:`TrainingDiverged`;
- :func:`elastic_train`: a bounded-restart driver around
  ``checkpoint.run_resumable``: a failed incarnation re-probes the
  devices and restarts from the latest checkpoint, at most
  ``max_restarts`` times; a divergence is raised at once (a replay would
  diverge the same way). Restarts count ``elastic.restarts`` in
  ``obs.metrics``.
"""

from __future__ import annotations

import concurrent.futures
import logging
import time
from collections import deque
from typing import Any, Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


class TrainingDiverged(RuntimeError):
    """Raised by :class:`DivergenceSentinel` when the loss stream goes
    non-finite or explodes."""


class DeviceProbeResult:
    def __init__(self, healthy: List, failed: List[Tuple[Any, str]],
                 latencies_s: List[float]):
        self.healthy = healthy
        self.failed = failed
        self.latencies_s = latencies_s

    @property
    def all_healthy(self) -> bool:
        return not self.failed

    def __repr__(self) -> str:
        return (
            f"DeviceProbeResult(healthy={len(self.healthy)}, "
            f"failed={[(str(d), e) for d, e in self.failed]})"
        )


def _probe_one(dev: torch.device) -> float:
    x = torch.arange(8, dtype=torch.float32, device=dev)
    got = float(torch.sum(x * 2.0))  # the fetch waits for the device
    if got != 56.0:
        raise RuntimeError(f"bad arithmetic: {got!r}")
    return got


def probe_devices(devices=None, deadline_s: float = 30.0) -> DeviceProbeResult:
    """Run a trivial computation on every device and fetch it: every CUDA
    device by default, the CPU when there is none. A device fails when
    the call raises, does not finish within ``deadline_s`` or returns the
    wrong sum."""
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [torch.device("cpu")])
    devices = [torch.device(d) for d in devices]
    healthy, failed, latencies = [], [], []
    # one thread per device; a wedged fetch strands its thread, not the
    # probe, so the pool is never joined
    pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=max(1, len(devices)), thread_name_prefix="eeg-probe"
    )
    try:
        futures = {dev: pool.submit(_probe_one, dev) for dev in devices}
        start = time.perf_counter()
        for dev, fut in futures.items():
            remaining = deadline_s - (time.perf_counter() - start)
            try:
                fut.result(timeout=max(0.0, remaining))
                latencies.append(time.perf_counter() - start)
                healthy.append(dev)
            except concurrent.futures.TimeoutError:
                fut.cancel()
                failed.append((dev, f"no response within {deadline_s:.0f}s"))
            except Exception as e:  # a lost device surfaces as a runtime error
                failed.append((dev, f"{type(e).__name__}: {e}"))
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    if failed:
        logger.warning("device probe failures: %s", failed)
    return DeviceProbeResult(healthy, failed, latencies)


class DivergenceSentinel:
    """``check(step, loss)`` raises :class:`TrainingDiverged` when the
    loss is non-finite, or exceeds ``explode_factor`` times the rolling
    median of the last ``window`` losses for ``patience`` consecutive
    steps."""

    def __init__(self, window: int = 20, explode_factor: float = 1e3, patience: int = 3):
        if window < 1 or patience < 1:
            raise ValueError("window and patience must be >= 1")
        self.window = window
        self.explode_factor = explode_factor
        self.patience = patience
        self._history: deque = deque(maxlen=window)
        self._strikes = 0

    def reset(self) -> None:
        """Forget the history (a restart replays its steps)."""
        self._history.clear()
        self._strikes = 0

    def check(self, step: int, loss) -> None:
        value = float(loss)
        if not np.isfinite(value):
            raise TrainingDiverged(f"non-finite loss {value!r} at step {step}")
        if len(self._history) == self.window:
            ref = float(np.median(self._history))
            if ref > 0 and value > self.explode_factor * ref:
                self._strikes += 1
                if self._strikes >= self.patience:
                    raise TrainingDiverged(
                        f"loss exploded at step {step}: {value:.3e} > "
                        f"{self.explode_factor:.0e} × rolling median "
                        f"{ref:.3e} for {self._strikes} steps"
                    )
            else:
                self._strikes = 0
        self._history.append(value)


def elastic_train(
    manager,
    init_state: Callable[[], Any],
    train_step: Callable,
    make_batches: Callable[[], Iterable],
    max_restarts: int = 3,
    save_every: int = 10,
    sentinel: Optional[DivergenceSentinel] = None,
    on_step: Optional[Callable[[int, Any], None]] = None,
    probe_on_failure: bool = True,
):
    """Run ``checkpoint.run_resumable`` to completion across transient
    failures: a failed incarnation is logged, the devices are re-probed
    (an unhealthy one aborts with the probe's evidence) and the run
    restarts from the latest checkpoint, at most ``max_restarts`` times.
    ``make_batches`` returns a fresh pass over the same sequence each
    call. Returns ``(state, last_step, restarts_used)``."""
    from .. import obs
    from ..checkpoint.manager import run_resumable

    def stepper(step: int, loss) -> None:
        if sentinel is not None:
            sentinel.check(step, loss)
        if on_step is not None:
            on_step(step, loss)

    restarts = 0
    while True:
        try:
            state, last = run_resumable(
                manager, init_state, train_step, make_batches(),
                save_every=save_every, on_step=stepper,
            )
            return state, last, restarts
        except TrainingDiverged:
            raise  # a replay from the same checkpoint diverges the same way
        except Exception as e:
            restarts += 1
            obs.metrics.count("elastic.restarts")
            logger.error(
                "training incarnation failed (%s: %s); restart %d/%d from step %s",
                type(e).__name__, e, restarts, max_restarts, manager.latest_step() or 0,
            )
            if restarts > max_restarts:
                obs.metrics.count("elastic.exhausted")
                raise
            if probe_on_failure:
                probe = probe_devices()
                if not probe.all_healthy:
                    obs.metrics.count("elastic.unhealthy_abort")
                    raise RuntimeError(
                        f"device(s) unhealthy after training failure, not "
                        f"restarting: {probe!r}"
                    ) from e
            if sentinel is not None:
                sentinel.reset()
