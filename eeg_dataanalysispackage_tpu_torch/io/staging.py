"""Host-to-device staging: a bounded background producer ahead of the
consumer.

Port of the JAX package's ``io/staging.py``. A producer thread pulls
items from a source iterator, stages each on the device and hands it
over through a small bounded buffer, so host work (parsing, planning)
and the copies overlap the consumer's own work:

    batches = staging.minibatches(epochs, targets, batch_size=1024)
    for ep, lb in staging.prefetch(batches, device="cuda"):
        ...

On a CUDA device the producer sets the card as its thread's current
device and runs its whole life on a stream of its own. The built-in
stage copies each array into pinned host memory and then to the card
with a non-blocking copy on that stream. After each item the producer
records a ``torch.cuda.Event`` and hands it over with the item; the
consumer makes its current stream wait on the event and calls
``record_stream`` on every tensor it receives, so the caching allocator
never hands that memory out again before the consumer's work on it is
done. A ``stage_fn`` runs on the producer thread inside the same stream:
whatever it launches (the fused ingest kernel under ``overlap=true``,
``io/provider.py``) runs there and is handed over by the same event. On
the CPU the built-in stage is ``torch.as_tensor`` (no pinning: pinned
memory needs CUDA).

The ``mesh=`` form pads each batch and splits it over the mesh's data
axis (``parallel/mesh.shard_batch_with_mask``: the arrays as float32
:class:`~..parallel.mesh.ShardedArray` s and a trailing validity mask,
or without the mask when ``with_mask`` is False); the producer waits for
its copies to the mesh's other cards before it hands an item over.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
from typing import Iterable, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import ENV_PREFETCH_DEPTH  # noqa: F401  (re-export: the knob's name)
from . import default_prefetch_depth
from ..obs import chaos, domain as run_domain, events
from ..parallel import mesh as pmesh
from ..utils.device import host_to_device, resolve_device

logger = logging.getLogger(__name__)

_END = object()

#: the staged-item bound when the caller passes no ``buffer_size``: the
#: shared ``EEG_TPU_PREFETCH_DEPTH`` knob (io/__init__.py), the same
#: source as the provider's parse look-ahead
default_buffer_size = default_prefetch_depth

#: how often the consumer's blocking get wakes to check that the producer
#: is alive: a producer that dies without delivering its end or its error
#: must not leave the consumer blocked on an empty queue forever
_WATCHDOG_POLL_S = 1.0


class _Poison:
    """A producer exception in transit to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class ProducerDiedError(RuntimeError):
    """The producer thread died without delivering its end-of-stream or
    its error; the consumer fails fast instead of blocking forever."""


def minibatches(
    *arrays: np.ndarray,
    batch_size: int,
    drop_remainder: bool = False,
) -> Iterator[Tuple[np.ndarray, ...]]:
    """Slice aligned host arrays into leading-axis minibatches."""
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    n = arrays[0].shape[0]
    for a in arrays[1:]:
        if a.shape[0] != n:
            raise ValueError(f"misaligned batch arrays: {a.shape[0]} vs {n} rows")
    for start in range(0, n, batch_size):
        if drop_remainder and start + batch_size > n:
            return
        yield tuple(a[start: start + batch_size] for a in arrays)


def _tensors(obj) -> Iterator[torch.Tensor]:
    """Every tensor inside a staged item (nested tuples and lists, and
    the shards of a sharded array)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, pmesh.ShardedArray):
        yield from obj.shards
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensors(x)


@contextlib.contextmanager
def _producer_stream(device: torch.device):
    """The producer thread's own CUDA stream on ``device`` (its current
    device and current stream for the block), or None on the CPU."""
    if device.type != "cuda":
        yield None
        return
    torch.cuda.set_device(device)
    side = torch.cuda.Stream(device=device)
    with torch.cuda.stream(side):
        yield side


def prefetch(
    batches: Iterable,
    device: Optional[Union[str, torch.device]] = None,
    buffer_size: Optional[int] = None,
    stage_fn=None,
    watchdog_poll_s: float = _WATCHDOG_POLL_S,
    mesh=None,
    with_mask: bool = True,
) -> Iterator:
    """Stage the items of ``batches`` on ``device`` ahead of consumption.

    Each item is a sequence of host arrays, yielded as a tuple of tensors
    on ``device`` (``None`` means ``cuda`` and raises without a card). A
    ``stage_fn`` replaces the built-in stage: the producer yields
    ``stage_fn(item)`` for each source item, which is the seam the
    provider's ``overlap=true`` rides (the function stages, plans and
    launches the kernel for recording K+1 while the consumer takes
    recording K). The bounded buffer, the error delivery, the stop on an
    early close, the consumer's watchdog and the ``staging.producer``
    chaos point apply to a ``stage_fn`` producer unchanged.

    ``mesh`` (a ``parallel.mesh.Mesh``): each item padded and split over
    the mesh's data axis, with a trailing validity mask when
    ``with_mask``; ``device`` is then the mesh's first device.

    ``buffer_size`` bounds the staged items in flight; None resolves
    ``EEG_TPU_PREFETCH_DEPTH`` (default 2). An exception raised by the
    source or by staging surfaces at the consumer, at its place in the
    order.
    """
    dev = resolve_device(device if mesh is None else mesh.first_device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if buffer_size is None:
        buffer_size = default_buffer_size()
    if buffer_size < 1:
        raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")

    def stage(batch: Sequence[np.ndarray]):
        if stage_fn is not None:
            return stage_fn(batch)
        if mesh is None:
            return tuple(host_to_device(a, dev) for a in batch)
        staged = (pmesh.shard_batch_with_mask(mesh, *batch) if with_mask
                  else tuple(pmesh.shard_batch(a, mesh)[0] for a in batch))
        # the item's event covers this thread's stream on dev only
        for other in {d for d in mesh.devices.flat if d.type == "cuda" and d != dev}:
            torch.cuda.current_stream(other).synchronize()
        return staged

    buf: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()
    # the producer's failure slot, set before delivery is attempted: if
    # the error never reaches the consumer (it stopped first), the
    # consumer's finally block still sees it and logs it
    failure: dict = {"error": None, "delivered": False, "logged": False}

    def _put_stop_aware(item) -> bool:
        """A polling put, so an abandoned consumer never wedges the
        producer; False when stop cut the delivery."""
        while not stop.is_set():
            try:
                buf.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    # the starting thread's run domain, adopted by the producer: the
    # staging.producer chaos point and its spans and metrics stay in the
    # right run
    domain = run_domain.capture()

    def producer() -> None:
        staged_n = 0
        # the producer's life is one span; the error event is emitted
        # inside it, so the failure is attributed to staging.producer
        with run_domain.adopt(domain), events.span("staging.producer") as span_rec:
            try:
                with _producer_stream(dev) as side:
                    for batch in batches:
                        if stop.is_set():
                            return
                        # chaos: one staged item fails; it must surface at
                        # the consumer, never drop silently
                        chaos.maybe_fire("staging.producer")
                        staged = stage(batch)
                        ready = None
                        if side is not None:
                            ready = torch.cuda.Event()
                            ready.record(side)
                        staged_n += 1
                        if span_rec is not None:
                            span_rec["attrs"]["batches"] = staged_n
                        if not _put_stop_aware((staged, ready)):
                            return
            except BaseException as e:  # re-raised at the consumer
                failure["error"] = e
                events.event("staging.producer_error", error=f"{type(e).__name__}: {e}",
                             batches_staged=staged_n)
                if not _put_stop_aware(_Poison(e)):
                    # the consumer already stopped: log here, a producer
                    # stranded past the consumer's join fails after the
                    # consumer's own check ran
                    failure["logged"] = True
                    logger.warning("prefetch producer failed after the consumer stopped "
                                   "(%s: %s); error was never delivered", type(e).__name__, e)
                return
            _put_stop_aware(_END)

    thread = threading.Thread(target=producer, name="eeg-tpu-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            # a timed get and a liveness check: the consumer's watchdog. A
            # producer that is merely slow (building a library, staging a
            # large recording) is alive and is waited for
            try:
                item = buf.get(timeout=watchdog_poll_s)
            except queue.Empty:
                if thread.is_alive():
                    continue
                try:
                    # the producer may have delivered its last item between
                    # the timeout and the liveness check
                    item = buf.get_nowait()
                except queue.Empty:
                    events.event("staging.producer_dead", thread=thread.name)
                    logger.error("prefetch producer thread %s died without delivering "
                                 "end-of-stream; failing the consumer fast", thread.name)
                    raise ProducerDiedError(
                        "staging producer thread died without delivering end-of-stream "
                        "or an error; the batch source may have failed outside the "
                        "producer's own failure handling"
                    )
            if item is _END:
                return
            if isinstance(item, _Poison):
                failure["delivered"] = True
                raise item.error
            staged, ready = item
            if ready is not None:
                # the consumer's stream waits for the producer's work on
                # this item, and the allocator keeps its memory until the
                # consumer's work on it is done
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(ready)
                for t in _tensors(staged):
                    if t.device == dev:
                        t.record_stream(stream)
            yield staged
    finally:
        # the consumer stopped (exhausted, failed or closed early): the
        # producer quits at its next check
        stop.set()
        thread.join(timeout=5.0)
        if thread.is_alive():
            logger.warning("prefetch producer thread %s still alive after 5s join; "
                           "abandoning it (daemon)", thread.name)
        err = failure["error"]
        if err is not None and not failure["delivered"] and not failure["logged"]:
            logger.warning("prefetch producer failed after the consumer stopped (%s: %s); "
                           "error was never delivered", type(err).__name__, err)


def prefetch_epochs(
    epochs: np.ndarray,
    targets: np.ndarray,
    batch_size: int,
    device: Optional[Union[str, torch.device]] = None,
    buffer_size: Optional[int] = None,
) -> Iterator[Tuple[torch.Tensor, ...]]:
    """:func:`minibatches` and :func:`prefetch` over an epoch set:
    float32 ``(epochs, targets)`` batches on ``device``."""
    return prefetch(
        minibatches(np.asarray(epochs, np.float32), np.asarray(targets, np.float32),
                    batch_size=batch_size),
        device=device,
        buffer_size=buffer_size,
    )
