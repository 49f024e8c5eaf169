"""Device meshes over the devices one process sees, and batch sharding.

Port of the JAX package's ``parallel/mesh.py``; :func:`parse_mesh` is
the plan parser's ``devices=``/``mesh_axes=`` grammar and
:class:`MeshRequest` its request (both defined in ``pipeline/plan.py``).

:class:`Mesh` stands in for ``jax.sharding.Mesh``: an ndarray of
``torch.device`` objects shaped by the mesh axes, with ``axis_names``, a
``shape`` dict and ``devices.size``. :func:`make_mesh` takes ``cuda:0 …
cuda:n-1`` on a card and raises when fewer cards are visible (the JAX
package degrades to one device there; the port has no ladder). With
``device="cpu"`` a mesh of N devices is N logical shards of the CPU. An
explicit ``devices=`` list may repeat a device (tests, and one-card
hosts).

Within a process there are no collectives, only explicit copies. A
sharded array is a :class:`ShardedArray`: one tensor a shard on that
shard's device. :func:`run_on_shards` runs one function a shard, each on
its own device and stream; results are gathered to the mesh's first
device in shard order (:func:`gather`, :func:`sum_in_order`).

A mesh may span processes (``parallel/distributed.hybrid_mesh``: a
``hosts`` axis outermost, one entry a process): it then knows its
``process_count``, its ``process_id`` and which of its entries are this
process's own (:meth:`Mesh.is_local`). A process holds only its own
shards; a :class:`ShardedArray` staged over such a mesh records the
process layout, and its sums and gathers cross processes by one
all-gather each (``distributed.all_gather_parts``), added or
concatenated in global shard order.
"""

from __future__ import annotations

from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..pipeline.plan import MeshRequest
from ..utils.device import host_to_device, resolve_device

DATA_AXIS = "data"
TIME_AXIS = "time"


class Mesh:
    """Devices laid out on named axes: ``devices`` is an object ndarray
    of ``torch.device`` shaped by the axes. A mesh over several processes
    names its ``process_axis`` (one entry a process, this one at
    ``process_id``); the entries of the other processes hold the devices
    those processes drive, as each sees them."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 process_count: int = 1, process_id: int = 0,
                 process_axis: Optional[str] = None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process_count = int(process_count)
        self.process_id = int(process_id)
        self.process_axis = process_axis

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, (int(s) for s in self.devices.shape)))

    def _local_row(self):
        """This process's index on every axis: its own on the process
        axis, a full slice elsewhere."""
        where = [slice(None)] * len(self.axis_names)
        if self.process_axis is not None:
            where[self.axis_names.index(self.process_axis)] = self.process_id
        return where

    @property
    def local_devices(self) -> List[torch.device]:
        """This process's devices, in mesh order."""
        return list(np.asarray(self.devices[tuple(self._local_row())]).flat)

    @property
    def first_device(self) -> torch.device:
        """This process's first device, where results are gathered."""
        return self.local_devices[0]

    def is_local(self, index: Sequence[int]) -> bool:
        """Whether the entry at ``index`` is one of this process's."""
        if self.process_axis is None:
            return True
        return int(index[self.axis_names.index(self.process_axis)]) == self.process_id

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` (index 0 on every other axis, this
        process's own on the process axis): the shards of an array
        sharded over ``axis`` and replicated over the rest."""
        where = [0] * len(self.axis_names)
        if self.process_axis is not None and axis != self.process_axis:
            where[self.axis_names.index(self.process_axis)] = self.process_id
        where[self.axis_names.index(axis)] = slice(None)
        return list(self.devices[tuple(where)])


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Tuple[str, ...] = (DATA_AXIS,),
    shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence] = None,
    device=None,
) -> Mesh:
    """Build a mesh over the first ``n_devices`` devices of ``device``'s
    kind (``None``: the cards, raising without one; ``"cpu"``: N logical
    CPU shards).

    1-D data mesh by default; pass ``axes``/``shape`` for 2-D layouts
    (e.g. ``axes=('data','time'), shape=(2,4)``). ``devices``: an
    explicit device list (it may repeat a device) instead of the
    ``[:n]`` prefix; ``n_devices`` must match its length when both are
    given."""
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            present = torch.cuda.device_count()
            n = n_devices or present
            if n > present:
                raise ValueError(f"requested {n} devices, only {present} present")
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            n = n_devices or 1
            devices = [dev] * n
    else:
        devices = [torch.device(d) for d in devices]
        n = n_devices or len(devices)
        if n != len(devices):
            raise ValueError(
                f"requested {n} devices but an explicit subset of "
                f"{len(devices)} was given; they must agree"
            )
    devs = np.empty(n, dtype=object)
    devs[:] = devices[:n]
    if shape is None:
        shape = (n,) if len(axes) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(
            f"mesh shape {shape} names {len(shape)} axes but "
            f"axes={axes} names {len(axes)}; give one extent per axis"
        )
    product = int(np.prod(shape)) if shape else 1
    if product != n:
        raise ValueError(
            f"mesh shape {shape} covers {product} devices but "
            f"{n} device(s) were requested; the axis extents must "
            f"multiply to the device count"
        )
    return Mesh(devs.reshape(shape), axes)


# -- the devices=/mesh_axes= grammar ------------------------------------------


def parse_mesh(query_map: Mapping[str, str], serve: bool) -> Optional[MeshRequest]:
    """The plan parser's ``devices=``/``mesh_axes=`` grammar
    (``pipeline/plan.ExecutionPlan._parse_mesh``): the typed request, or
    None when neither key is given."""
    from ..pipeline.plan import ExecutionPlan

    return ExecutionPlan._parse_mesh(query_map, serve)


# -- sharded arrays -----------------------------------------------------------


class ShardedArray:
    """One array split along ``dim`` into contiguous shards, shard ``i``
    a tensor on the ``i``-th device of the axis it was split over. Over
    ``process_count`` processes, ``shards`` are this process's, the
    ``process_id``-th equal block of the global array (process-major)."""

    def __init__(self, shards: Sequence[torch.Tensor], dim: int = 0,
                 process_count: int = 1, process_id: int = 0):
        self.shards = list(shards)
        self.dim = dim
        self.process_count = int(process_count)
        self.process_id = int(process_id)

    @property
    def across_processes(self) -> bool:
        return self.process_count > 1

    @property
    def devices(self) -> List[torch.device]:
        return [s.device for s in self.shards]

    @property
    def device(self) -> torch.device:
        """The first shard's device, where results are gathered."""
        return self.shards[0].device

    @property
    def local_length(self) -> int:
        """This process's extent along ``dim``."""
        return sum(s.shape[self.dim] for s in self.shards)

    @property
    def shape(self) -> Tuple[int, ...]:
        """The global shape (every process holds an equal block)."""
        shape = list(self.shards[0].shape)
        shape[self.dim] = self.local_length * self.process_count
        return tuple(shape)

    def _like(self, shards) -> "ShardedArray":
        return ShardedArray(shards, self.dim, self.process_count, self.process_id)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "ShardedArray":
        return self._like([fn(s) for s in self.shards])

    def split(self, full: torch.Tensor) -> "ShardedArray":
        """``full`` (this array's global length along ``dim``) cut like
        this array: this process's block, each piece on its shard's
        device."""
        if self.across_processes:
            full = full.narrow(self.dim, self.process_id * self.local_length, self.local_length)
        sizes = [s.shape[self.dim] for s in self.shards]
        return self._like([p.to(d) for p, d in zip(torch.split(full, sizes, self.dim),
                                                    self.devices)])

    def __mul__(self, other) -> "ShardedArray":
        if isinstance(other, torch.Tensor):
            other = self.split(other)
        return self._like([a * b for a, b in zip(self.shards, other.shards)])

    def sum(self) -> torch.Tensor:
        """The sum of every element, shard sums added in global shard
        order on the first device."""
        return sum_in_order([s.sum() for s in self.shards], self.device,
                            across_processes=self.across_processes)

    def gather(self) -> torch.Tensor:
        """The whole array on the first device, shards in global order."""
        if self.across_processes:
            from . import distributed

            return torch.cat(distributed.all_gather_parts(self.shards, self.device), self.dim)
        return gather(self.shards, self.device, self.dim)


def gather(parts: Sequence[torch.Tensor], device: torch.device, dim: int = 0) -> torch.Tensor:
    """``parts`` copied to ``device`` and concatenated in order."""
    return torch.cat([p.to(device) for p in parts], dim)


def sum_in_order(parts: Sequence[torch.Tensor], device: torch.device,
                 across_processes: bool = False) -> torch.Tensor:
    """``parts`` copied to ``device`` and added one after another, in
    order (the port's all-reduce: the order is fixed, XLA's psum's is
    not). ``across_processes``: ``parts`` are this process's shards of a
    multi-process mesh; every process's are all-gathered first and added
    in global shard order, so every process gets the bits one process
    over all the shards gives."""
    if across_processes:
        from . import distributed

        parts = distributed.all_gather_parts(parts, device)
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def pad_to_multiple(array: np.ndarray, multiple: int, axis: int = 0):
    """Pad ``axis`` up to a multiple (shards are even).

    Returns (padded, original_length). Padding rows are zeros; callers
    mask them out of reductions via the returned length.
    """
    n = array.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return array, n
    widths = [(0, 0)] * array.ndim
    widths[axis] = (0, rem)
    return np.pad(array, widths), n


def shard_batch(array, mesh: Mesh, axis_name: str = DATA_AXIS):
    """Pad a host batch and copy one even piece to each device of the
    mesh's ``axis_name``; returns (ShardedArray, original length). Over a
    multi-process mesh the batch (the same on every process) is padded
    and cut for the processes' devices together, and this process keeps
    its own pieces."""
    devices = mesh.axis_devices(axis_name)
    n_shards = len(devices) * mesh.process_count
    padded, n = pad_to_multiple(np.asarray(array), n_shards)
    pieces = np.split(padded, n_shards)[mesh.process_id * len(devices):][:len(devices)]
    return ShardedArray([host_to_device(np.ascontiguousarray(p), d)
                         for p, d in zip(pieces, devices)],
                        process_count=mesh.process_count, process_id=mesh.process_id), n


def shard_batch_with_mask(mesh: Mesh, *arrays, axis_name: str = DATA_AXIS):
    """Pad + shard float32 batch arrays, plus a 1/0 validity mask over
    the padded rows: the padding/masking convention of data-parallel SGD
    and the MLP train steps."""
    out, n, padded_len = [], None, None
    for a in arrays:
        sharded, n = shard_batch(np.asarray(a, np.float32), mesh, axis_name)
        padded_len = sharded.shape[0]
        out.append(sharded)
    mask = np.zeros(padded_len, dtype=np.float32)
    mask[:n] = 1.0
    out.append(shard_batch(mask, mesh, axis_name)[0])
    return tuple(out)


# -- one function a shard ----------------------------------------------------


def _record(obj, stream) -> None:
    """``record_stream`` on every CUDA tensor inside ``obj``."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            obj.record_stream(stream)
    elif isinstance(obj, Mapping):
        for v in obj.values():
            _record(v, stream)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _record(v, stream)


def run_on_shards(devices: Sequence[torch.device], fn: Callable) -> list:
    """``fn(i, device)`` for every shard ``i``, issued in shard order from
    the calling thread; the results in shard order.

    On cards each shard runs on a stream of its own on its device (a
    fresh stream that first waits for the caller's current stream there,
    so it sees the caller's inputs); the caller's current streams then
    wait for every shard's, and the results are recorded on them. A
    thread a shard was slower, on one card and on four, as the shards'
    host loops share one interpreter (a 16-member population's four
    shards took 1.28 s threaded on four cards and 0.47-0.59 s in turn on
    one card or four: ``chip_smoke.py`` phase 4i on NVIDIA H100 80GB HBM3
    cards at 700 W). On the CPU the shards simply run in turn."""
    devices = [torch.device(d) for d in devices]
    if devices[0].type != "cuda":
        return [fn(i, d) for i, d in enumerate(devices)]
    callers = {d: torch.cuda.current_stream(d) for d in devices}
    streams = []
    for d in devices:
        stream = torch.cuda.Stream(device=d)
        stream.wait_stream(callers[d])
        streams.append(stream)
    results = []
    for i, (d, stream) in enumerate(zip(devices, streams)):
        with torch.cuda.device(d), torch.cuda.stream(stream):
            results.append(fn(i, d))
    for d, stream, result in zip(devices, streams, results):
        callers[d].wait_stream(stream)
        _record(result, callers[d])
    return results
