"""Multi-process runtime: the bootstrap over ``torch.distributed``, hybrid
hosts x local-device meshes, per-process staging and the collectives.

Port of the JAX package's ``parallel/distributed.py``. The JAX-free half is
kept as it is there: the env twins of the pod knobs
(:func:`resolve_env_knobs`), the plain-TCP preflight barrier on the
coordinator's port + 1 (:func:`_preflight_rendezvous`) that turns an
unreachable coordinator or a missing peer into a :class:`PodBootstrapError`
within the bootstrap deadline, and :func:`free_port_pair`.

- :func:`initialize` runs the same checks and the preflight, then
  ``torch.distributed.init_process_group`` at ``tcp://<coordinator>``
  with the world size, the rank and the deadline; a single process is a
  no-op. The collectives' backend is chosen by topology, never by what
  fails: the ranks exchange the UUIDs of the cards they drive over the
  gloo group the bootstrap makes, and where every rank drives cards of
  its own the collectives run over an NCCL group; where ranks share a
  card (one-card hosts, tests) or run on the CPU they stay on gloo,
  whose CUDA rows go through pinned host memory.
- :func:`hybrid_mesh`: a ``hosts`` axis over the processes outermost,
  then the process's local devices (the cards it sees, so a launcher
  hands a rank its card with ``CUDA_VISIBLE_DEVICES``; on the CPU one
  logical device unless ``ici_shape`` asks for more).
- :func:`stage_global_batch` / :func:`stage_local`: each process keeps
  only its own shard of a global batch; :func:`all_gather_parts` and
  :func:`all_gather` assemble the global view in process order;
  :func:`exchange_halo` is the point-to-point ring hop of the streaming
  front end.

``exchange_collective_hlo`` and ``shard_map`` are XLA's and have no
counterpart here.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import host_to_device, resolve_device
from . import mesh as pmesh

logger = logging.getLogger(__name__)

DCN_AXIS = "hosts"

#: bootstrap deadline (seconds) of the preflight rendezvous and of
#: ``init_process_group``; the builder's query/env resolution passes it on
ENV_BOOTSTRAP_TIMEOUT = "EEG_TPU_POD_TIMEOUT_S"
_DEFAULT_BOOTSTRAP_TIMEOUT_S = 60.0

#: set to "1" to skip the preflight rendezvous (a launcher that already
#: guarantees the cluster, or a coordinator whose port + 1 is not usable)
ENV_NO_PREFLIGHT = "EEG_TPU_POD_NO_PREFLIGHT"

_initialized = False
#: the (coordinator, num_processes, process_id) the live bootstrap used
_resolution: Optional[Tuple[Optional[str], int, int]] = None
#: the collectives' backend ("nccl" or "gloo") and, for NCCL, its group
_backend: Optional[str] = None
_group = None


class PodBootstrapError(ConnectionError):
    """The multi-process bootstrap could not assemble the pod within its
    deadline (coordinator unreachable, a peer missing), raised by the
    preflight before ``init_process_group`` runs. The JAX package's
    pipeline degrades to one host on it; the port's raises it."""


def default_bootstrap_timeout() -> float:
    value = os.environ.get(ENV_BOOTSTRAP_TIMEOUT)
    if not value:
        return _DEFAULT_BOOTSTRAP_TIMEOUT_S
    try:
        return float(value)
    except ValueError:
        logger.warning(
            "unparseable %s=%r; using the default %.0fs",
            ENV_BOOTSTRAP_TIMEOUT, value, _DEFAULT_BOOTSTRAP_TIMEOUT_S,
        )
        return _DEFAULT_BOOTSTRAP_TIMEOUT_S


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value is not None else None


def resolve_env_knobs(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[Optional[str], Optional[int], Optional[int]]:
    """Fill None knobs from the env twins ``JAX_COORDINATOR_ADDRESS`` (or
    ``JAX_COORDINATOR``) / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``: the
    one query-over-env resolution shared by :func:`initialize` and the
    builder's ``_resolve_pod``."""
    if coordinator_address is None:
        coordinator_address = (
            os.environ.get("JAX_COORDINATOR_ADDRESS")
            or os.environ.get("JAX_COORDINATOR")
            or None
        )
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID")
    return coordinator_address, num_processes, process_id


def _split_host_port(coordinator_address: str) -> Tuple[str, int]:
    host, sep, port = coordinator_address.rpartition(":")
    if not sep or not host:
        raise ValueError(
            f"coordinator address {coordinator_address!r} is not "
            f"host:port"
        )
    return host, int(port)


def _preflight_rendezvous(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    timeout_s: float,
) -> None:
    """Plain-TCP barrier on ``coordinator port + 1`` before the real
    bootstrap (the JAX package's, message for message).

    Process 0 listens; every other process connects, sends its id, and
    blocks on the ack process 0 sends only once all peers have arrived.
    Success means every process is alive and about to enter the real
    bootstrap together; failure raises :class:`PodBootstrapError` within
    ``timeout_s`` on every process.
    """
    host, port = _split_host_port(coordinator_address)
    deadline = time.monotonic() + timeout_s
    rendezvous_port = port + 1
    if process_id == 0:
        try:
            server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            server.bind(("", rendezvous_port))
            server.listen(num_processes)
        except OSError as e:
            raise PodBootstrapError(
                f"preflight rendezvous could not listen on port "
                f"{rendezvous_port}: {e}"
            )
        peers: dict = {}  # peer process id -> live connection
        stray = []
        try:
            while len(peers) < num_processes - 1:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise PodBootstrapError(
                        f"preflight rendezvous timed out after "
                        f"{timeout_s:.0f}s with {len(peers)}/"
                        f"{num_processes - 1} peer processes arrived"
                    )
                server.settimeout(min(remaining, 1.0))
                try:
                    conn, _addr = server.accept()
                except socket.timeout:
                    continue
                conn.settimeout(max(deadline - time.monotonic(), 0.1))
                # an arrived peer sends its decimal process id; a port
                # scanner or health probe sends nothing and must not
                # count; a duplicate id replaces the stale connection
                try:
                    data = conn.recv(16)
                except OSError:
                    conn.close()
                    continue
                text = data.decode("ascii", errors="replace").strip()
                if not text.isdigit() or not (
                    1 <= int(text) <= num_processes - 1
                ):
                    conn.close()
                    continue
                pid = int(text)
                if pid in peers:
                    stray.append(peers.pop(pid))
                peers[pid] = conn
            for conn in peers.values():
                try:
                    conn.sendall(b"ok")
                except OSError:
                    pass
        finally:
            for conn in list(peers.values()) + stray:
                conn.close()
            server.close()
        return
    # the other processes: connect with retries until the deadline
    last_error: Optional[Exception] = None
    while time.monotonic() < deadline:
        try:
            with socket.create_connection(
                (host, rendezvous_port),
                timeout=max(min(deadline - time.monotonic(), 2.0), 0.1),
            ) as conn:
                conn.sendall(str(process_id).encode())
                conn.settimeout(max(deadline - time.monotonic(), 0.1))
                # read until the 2-byte ack or EOF: a short read is not a
                # failed rendezvous
                ack = b""
                while len(ack) < 2:
                    chunk = conn.recv(2 - len(ack))
                    if not chunk:
                        break
                    ack += chunk
                if ack == b"ok":
                    return
                last_error = ConnectionError("rendezvous closed early")
        except OSError as e:
            last_error = e
            time.sleep(min(0.2, max(deadline - time.monotonic(), 0.0)))
    raise PodBootstrapError(
        f"coordinator {coordinator_address} unreachable within "
        f"{timeout_s:.0f}s (preflight): {last_error}"
    )


def free_port_pair(attempts: int = 16) -> int:
    """A loopback port whose neighbour is also bindable: the preflight
    listens on coordinator port + 1, so a coordinator address is usable
    only when both are free."""
    for _ in range(attempts):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        try:
            s2 = socket.socket()
            try:
                s2.bind(("", port + 1))
            except OSError:
                continue
            s2.close()
            return port
        finally:
            s.close()
    raise RuntimeError("no free coordinator port pair found")


def _card_uuids(device: torch.device) -> List[str]:
    """The UUIDs of the cards this process drives (none on the CPU)."""
    if device.type != "cuda":
        return []
    return [str(torch.cuda.get_device_properties(i).uuid)
            for i in range(torch.cuda.device_count())]


def choose_backend(uuids_by_rank: Sequence[Sequence[str]]) -> str:
    """``nccl`` when every rank drives cards and no card is driven by two
    ranks; ``gloo`` when ranks share a card or run on the CPU."""
    flat = [u for uuids in uuids_by_rank for u in uuids]
    if all(uuids_by_rank) and len(set(flat)) == len(flat):
        return "nccl"
    return "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: Optional[float] = None,
    device=None,
) -> Tuple[Optional[str], int, int]:
    """Bootstrap the multi-process runtime (idempotent).

    Arguments default to the env twins (:func:`resolve_env_knobs`); with
    neither a coordinator nor a process count configured this is a no-op
    returning ``(None, 1, 0)``. Returns the resolved ``(coordinator,
    num_processes, process_id)``; repeat calls return the live
    bootstrap's. ``device`` (None: the card) is what this rank drives; it
    decides the collectives' backend with the other ranks' (the module's
    docstring). An unreachable coordinator or a missing peer raises
    :class:`PodBootstrapError` within ``timeout_s`` (default
    ``EEG_TPU_POD_TIMEOUT_S``, 60 s), from the preflight; the port has no
    cluster auto-detection, so a pod without a coordinator address or a
    process id raises it too.
    """
    global _initialized, _resolution, _backend, _group
    if _initialized:
        assert _resolution is not None
        return _resolution
    coordinator_address, num_processes, process_id = resolve_env_knobs(
        coordinator_address, num_processes, process_id
    )
    if coordinator_address is None and num_processes is None:
        if process_id is not None:
            raise ValueError(
                "JAX_PROCESS_ID/process_id is set but neither a "
                "coordinator address nor a process count is configured "
                "— refusing to run as single-process with a partial "
                "multi-host setup"
            )
        _resolution = (None, 1, 0)
        return _resolution  # single process; nothing to bootstrap
    if timeout_s is None:
        timeout_s = default_bootstrap_timeout()
    if coordinator_address is None:
        raise PodBootstrapError(
            f"no coordinator address for a {num_processes}-process pod; set "
            "coordinator=/JAX_COORDINATOR_ADDRESS (the port has no cluster "
            "auto-detection)"
        )
    if num_processes is None:
        raise PodBootstrapError(
            f"no process count for the pod at {coordinator_address}; set "
            "processes=/JAX_NUM_PROCESSES"
        )
    if process_id is None:
        raise PodBootstrapError(
            "process_id unresolved for an explicit "
            f"coordinator={coordinator_address} num_processes="
            f"{num_processes} bootstrap; set process_id=/JAX_PROCESS_ID"
        )
    dev = resolve_device(device)
    if num_processes > 1 and os.environ.get(ENV_NO_PREFLIGHT) != "1":
        _preflight_rendezvous(
            coordinator_address, num_processes, process_id, timeout_s
        )
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=max(float(timeout_s), 1.0))
    dist.init_process_group(
        backend="gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id), timeout=timeout,
    )
    try:
        uuids = [None] * int(num_processes)
        dist.all_gather_object(uuids, _card_uuids(dev))
        backend = choose_backend(uuids)
        group = None
        if backend == "nccl":
            if not dist.is_nccl_available():
                raise RuntimeError(
                    "every rank of this pod drives a card of its own, which "
                    "takes NCCL collectives, and this torch build has no NCCL"
                )
            torch.cuda.set_device(dev if dev.index is not None else 0)
            group = dist.new_group(backend="nccl", timeout=timeout)
            # NCCL sets its communicator up at a group's first collective
            # (2.5-2.7 s on four NVIDIA H100 80GB HBM3 cards at 700 W,
            # chip_smoke.py phase 4j): here, in the bootstrap, not in the
            # run's first exchange
            dist.all_reduce(torch.zeros(1, device="cuda"), group=group)
            torch.cuda.synchronize()
    except Exception:
        dist.destroy_process_group()
        raise
    _initialized, _backend, _group = True, backend, group
    _resolution = (coordinator_address, int(dist.get_world_size()), int(dist.get_rank()))
    logger.info(
        "distributed runtime up: process %d/%d over %s (%s)",
        _resolution[2], _resolution[1], backend, dev,
    )
    return _resolution


def shutdown() -> None:
    """Tear the process group down and reset the latch, so
    :func:`initialize` can run again in this process. Safe to call when
    nothing was initialized."""
    global _initialized, _resolution, _backend, _group
    if _initialized:
        import torch.distributed as dist

        try:
            dist.destroy_process_group()
        except Exception as e:  # pragma: no cover - defensive teardown
            logger.warning("destroy_process_group failed: %s", e)
    _initialized = False
    _resolution = None
    _backend = _group = None


def is_initialized() -> bool:
    """True while a multi-process bootstrap from :func:`initialize` is
    live (the latch :func:`shutdown` resets)."""
    return _initialized


def backend() -> Optional[str]:
    """The live bootstrap's collectives backend, None without one."""
    return _backend


def process_count() -> int:
    return _resolution[1] if _initialized else 1


def process_index() -> int:
    return _resolution[2] if _initialized else 0


def hybrid_mesh(
    ici_axes: Tuple[str, ...] = (pmesh.DATA_AXIS,),
    ici_shape: Optional[Sequence[int]] = None,
    dcn_axis: str = DCN_AXIS,
    device=None,
    devices: Optional[Sequence] = None,
) -> pmesh.Mesh:
    """A mesh with ``dcn_axis`` (outermost) over the processes and
    ``ici_axes`` over each process's local devices: on a card the cards
    this process sees (``ici_shape`` must cover them), on the CPU one
    logical device unless ``ici_shape`` asks for more; ``devices``, an
    explicit local device list, may repeat a device (tests, one-card
    hosts). Single-process the hosts axis has size 1."""
    if devices is not None:
        local = [torch.device(d) for d in devices]
    else:
        dev = resolve_device(device)
        local = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                 if dev.type == "cuda" else None)
    if ici_shape is None:
        if len(ici_axes) != 1:
            raise ValueError("ici_shape required for multi-axis ICI layouts")
        ici_shape = (len(local) if local is not None else 1,)
    ici_shape = tuple(int(s) for s in ici_shape)
    n_local = int(np.prod(ici_shape))
    if local is not None and n_local != len(local):
        raise ValueError(
            f"ici_shape {ici_shape} must cover the {len(local)} local devices"
        )
    if local is None:  # logical CPU shards
        local = [dev] * n_local
    n_proc = process_count()
    devices = np.empty((n_proc, n_local), dtype=object)
    for p in range(n_proc):
        devices[p, :] = local
    return pmesh.Mesh(devices.reshape((n_proc,) + ici_shape), (dcn_axis,) + tuple(ici_axes),
                      process_count=n_proc, process_id=process_index(),
                      process_axis=dcn_axis)


def batch_spec(mesh: pmesh.Mesh, dcn_axis: str = DCN_AXIS):
    """The axes a leading batch axis shards over: every data-parallel axis
    present, DCN outer, ICI inner (a tuple for both, the bare name for
    one), as the JAX package's ``PartitionSpec`` entry."""
    axes = tuple(a for a in (dcn_axis, pmesh.DATA_AXIS) if a in mesh.axis_names)
    if not axes:
        raise ValueError(f"mesh {mesh.axis_names} has no data-parallel axis")
    return axes if len(axes) > 1 else axes[0]


def stage_local(local, mesh: pmesh.Mesh, axis: str = pmesh.DATA_AXIS,
                dim: int = 0) -> pmesh.ShardedArray:
    """This process's block of a global array (``local``, host data) split
    evenly along ``dim`` over its devices on ``axis``: the per-process
    half of the JAX package's ``make_array_from_process_local_data``. The
    global array is the processes' blocks in process order."""
    local = local.cpu().numpy() if isinstance(local, torch.Tensor) else np.asarray(local)
    devices = mesh.axis_devices(axis)
    if local.shape[dim] % len(devices):
        raise ValueError(
            f"local extent {local.shape[dim]} not divisible by the "
            f"{len(devices)} local devices on {axis!r}"
        )
    pieces = np.split(local, len(devices), axis=dim)
    return pmesh.ShardedArray([host_to_device(np.ascontiguousarray(p), d)
                               for p, d in zip(pieces, devices)], dim,
                              mesh.process_count, mesh.process_id)


def stage_global_batch(local_batch, mesh: pmesh.Mesh,
                       dcn_axis: str = DCN_AXIS) -> pmesh.ShardedArray:
    """This process's slice of a global batch over its data-parallel
    devices; the global leading dimension is the sum over processes,
    sharded over :func:`batch_spec`'s axes."""
    axes = batch_spec(mesh, dcn_axis)
    ici = [a for a in ((axes,) if isinstance(axes, str) else axes) if a != dcn_axis]
    if ici:
        return stage_local(local_batch, mesh, ici[0])
    return stage_local(local_batch, mesh, dcn_axis)


def replicate_across_hosts(tree, mesh: pmesh.Mesh):
    """Host values (every process must pass identical ones) as tensors on
    this process's first device: the parameter broadcast."""
    dev = mesh.first_device
    if isinstance(tree, dict):
        return {k: replicate_across_hosts(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate_across_hosts(v, mesh) for v in tree)
    return host_to_device(np.asarray(tree), dev)


# -- collectives --------------------------------------------------------------


def _via_host(t: torch.Tensor) -> bool:
    return _backend != "nccl" and t.is_cuda


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend takes it: gloo moves CPU tensors, so a card's
    rows go through pinned host memory."""
    t = t.contiguous()
    if _via_host(t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t


def all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every process's ``t`` (one shape and dtype on every process), in
    process order, on ``t``'s device: one all-gather."""
    import torch.distributed as dist

    if not _initialized:
        return [t]
    wire = _to_wire(t)
    out = [torch.empty_like(wire) for _ in range(process_count())]
    dist.all_gather(out, wire, group=_group)
    if _via_host(t):
        return [o.to(t.device, non_blocking=True) for o in out]
    return out


def all_gather_parts(parts: Sequence[torch.Tensor], device) -> List[torch.Tensor]:
    """This process's shard values ``parts`` (one shape each, as many on
    every process) gathered from every process in global shard order
    (process-major): one all-gather of the stacked parts, on ``device``."""
    stacked = torch.stack([p.to(device) for p in parts])
    return [row for block in all_gather(stacked) for row in block]


def exchange_halo(head: torch.Tensor) -> torch.Tensor:
    """The ring hop across processes: this process sends ``head`` to the
    previous process and returns the next process's (the last process
    gets process 0's). Point to point; one shape on every process."""
    import torch.distributed as dist

    n, pid = process_count(), process_index()
    if n == 1:
        return head
    wire = _to_wire(head)
    incoming = torch.empty_like(wire)
    ops = [dist.P2POp(dist.isend, wire, (pid - 1) % n, group=_group),
           dist.P2POp(dist.irecv, incoming, (pid + 1) % n, group=_group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return incoming.to(head.device, non_blocking=True) if _via_host(head) else incoming
