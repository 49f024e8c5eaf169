"""Device meshes over the devices one process sees, and batch sharding.

Port of the JAX package's ``parallel/mesh.py`` and of its plan parser's
``devices=``/``mesh_axes=`` grammar (``pipeline/plan.py``:
:class:`MeshRequest`, :func:`parse_mesh`, with its messages).

:class:`Mesh` stands in for ``jax.sharding.Mesh``: an ndarray of
``torch.device`` objects shaped by the mesh axes, with ``axis_names``, a
``shape`` dict and ``devices.size``. :func:`make_mesh` takes ``cuda:0 …
cuda:n-1`` on a card and raises when fewer cards are visible (the JAX
package degrades to one device there; the port has no ladder). With
``device="cpu"`` a mesh of N devices is N logical shards of the CPU. An
explicit ``devices=`` list may repeat a device (tests, and one-card
hosts).

There are no collectives here, only explicit copies. A sharded array is
a :class:`ShardedArray`: one tensor a shard on that shard's device.
:func:`run_on_shards` runs one function a shard, each on its own device
and stream; results are gathered to the mesh's first device in shard
order (:func:`gather`, :func:`sum_in_order`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import host_to_device, resolve_device

DATA_AXIS = "data"
TIME_AXIS = "time"


class Mesh:
    """Devices laid out on named axes: ``devices`` is an object ndarray
    of ``torch.device`` shaped by the axes."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, (int(s) for s in self.devices.shape)))

    @property
    def first_device(self) -> torch.device:
        return self.devices.flat[0]

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` (index 0 on every other axis): the
        shards of an array sharded over ``axis`` and replicated over the
        rest."""
        where = [0] * len(self.axis_names)
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


@dataclasses.dataclass(frozen=True)
class MeshRequest:
    """The ``devices=``/``mesh_axes=`` grammar, validated."""

    devices: Optional[int]
    axes: Tuple[str, ...]
    shape: Optional[Tuple[int, ...]]


def parse_mesh(query_map: Mapping[str, str], serve: bool) -> Optional[MeshRequest]:
    """The JAX package's ``_parse_mesh`` with its messages: the typed
    request, or None when neither key is given."""
    from ..pipeline.builder import int_param

    devices_param = int_param(query_map, "devices")
    axes_value = query_map.get("mesh_axes", "")
    if devices_param is None and not axes_value:
        return None
    if serve:
        raise ValueError(
            "devices=/mesh_axes= shard the batch pipeline; they "
            "cannot combine with serve=true (the serving engine "
            "is resident single-device)"
        )
    axes, sizes = [], []
    if axes_value:
        for part in axes_value.split(","):
            name, sep, size = part.partition(":")
            name = name.strip()
            if not name:
                raise ValueError(f"mesh_axes= has an empty axis name in {axes_value!r}")
            axes.append(name)
            if sep:
                try:
                    sizes.append(int(size))
                except ValueError:
                    raise ValueError(
                        f"mesh_axes= axis {name!r} has a non-integer extent {size!r}"
                    ) from None
        if len(set(axes)) != len(axes):
            raise ValueError("mesh_axes= repeats an axis name")
        if sizes and len(sizes) != len(axes):
            raise ValueError(
                "mesh_axes= extents must be given for every axis "
                "or for none (e.g. mesh_axes=data:2,time:4)"
            )
        if len(axes) > 1 and not sizes:
            raise ValueError(
                "multi-axis mesh_axes= needs explicit extents "
                "(e.g. mesh_axes=data:2,time:4)"
            )
    if not axes:
        axes = [DATA_AXIS]
    if devices_param is not None and devices_param < 1:
        raise ValueError("devices= must be >= 1")
    product = int(np.prod(sizes)) if sizes else None
    if product is not None and devices_param is not None and product != devices_param:
        raise ValueError(
            f"mesh_axes= extents cover {product} devices but "
            f"devices={devices_param}; drop one or make them agree"
        )
    return MeshRequest(devices=devices_param, axes=tuple(axes),
                       shape=tuple(sizes) if sizes else None)


# -- sharded arrays -----------------------------------------------------------


class ShardedArray:
    """One array split along ``dim`` into contiguous shards, shard ``i``
    a tensor on the ``i``-th device of the axis it was split over."""

    def __init__(self, shards: Sequence[torch.Tensor], dim: int = 0):
        self.shards = list(shards)
        self.dim = dim

    @property
    def devices(self) -> List[torch.device]:
        return [s.device for s in self.shards]

    @property
    def device(self) -> torch.device:
        """The first shard's device, where results are gathered."""
        return self.shards[0].device

    @property
    def shape(self) -> Tuple[int, ...]:
        shape = list(self.shards[0].shape)
        shape[self.dim] = sum(s.shape[self.dim] for s in self.shards)
        return tuple(shape)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "ShardedArray":
        return ShardedArray([fn(s) for s in self.shards], self.dim)

    def split(self, full: torch.Tensor) -> "ShardedArray":
        """``full`` (this array's length along ``dim``) cut like this
        array, each piece on its shard's device."""
        sizes = [s.shape[self.dim] for s in self.shards]
        return ShardedArray([p.to(d) for p, d in zip(torch.split(full, sizes, self.dim),
                                                      self.devices)], self.dim)

    def __mul__(self, other) -> "ShardedArray":
        if isinstance(other, torch.Tensor):
            other = self.split(other)
        return ShardedArray([a * b for a, b in zip(self.shards, other.shards)], self.dim)

    def sum(self) -> torch.Tensor:
        """The sum of every element, shard sums added in shard order on
        the first device."""
        return sum_in_order([s.sum() for s in self.shards], self.device)

    def gather(self) -> torch.Tensor:
        """The whole array on the first device, shards in order."""
        return gather(self.shards, self.device, self.dim)


def gather(parts: Sequence[torch.Tensor], device: torch.device, dim: int = 0) -> torch.Tensor:
    """``parts`` copied to ``device`` and concatenated in order."""
    return torch.cat([p.to(device) for p in parts], dim)


def sum_in_order(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """``parts`` copied to ``device`` and added one after another, in
    order (the port's all-reduce: the order is fixed, XLA's psum's is
    not)."""
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
    mesh's ``axis_name``; returns (ShardedArray, original length)."""
    padded, n = pad_to_multiple(np.asarray(array), mesh.shape[axis_name])
    devices = mesh.axis_devices(axis_name)
    pieces = np.split(padded, len(devices))
    return ShardedArray([host_to_device(np.ascontiguousarray(p), d)
                         for p, d in zip(pieces, devices)]), n


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
