"""Pod-scale partitioned ingest: per-process recording subsets feeding one
global feature matrix.

Port of the JAX package's ``parallel/pod.py``:

- each process ingests a disjoint, contiguous block of the recordings
  (:func:`partition`, ``np.array_split`` semantics), so the waveform
  bytes, the staging and the fused kernel (K1, ``ops/ingest_cuda``) scale
  ~1/N a process;
- the run's cross-recording state (the order-dependent balance scan, the
  stale channel-index reuse) depends on marker and header metadata only,
  so every process runs the same metadata pass over every recording
  (:func:`plan_pod_ingest`: the .vhdr/.vmrk text and the .eeg byte count)
  and each recording's ingest plan is the single-process run's;
- each feature row is computed by exactly one process with the
  single-process run's per-recording launch, so the assembled matrix is
  bit-identical to the unpartitioned run's;
- assembly is one collective (:func:`exchange_features`): each process's
  rows padded to the largest process's count, one all-gather in process
  order over ``torch.distributed`` (``parallel/distributed.all_gather``),
  the padding sliced off.

The JAX package's ``exchange_collective_hlo`` asserts the all-gather in
XLA's compiled program; there is no such program here.

The ``processes=``/``coordinator=``/``process_id=`` grammar is the plan
parser's (``pipeline/plan.ExecutionPlan._parse_pod``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


#: the pod knobs' env twins a spawner's own environment must not leak
_POD_ENV = ("JAX_NUM_PROCESSES", "JAX_COORDINATOR", "JAX_COORDINATOR_ADDRESS",
            "JAX_PROCESS_ID")


def spawn_pod_member(
    query: str,
    coordinator: str,
    num_processes: int,
    process_id: int,
    parent_pid: Optional[int] = None,
    timeout_s: Optional[str] = None,
    device: Optional[str] = None,
    visible_devices: Optional[str] = None,
):
    """One fresh ``parallel.pod_worker`` subprocess of this package for rank
    ``process_id`` of a ``num_processes`` pod at ``coordinator``.

    The pod knobs ride the query; the spawner's own ``JAX_*`` pod env is
    popped, so the child's membership is what the query says.
    ``timeout_s`` becomes the child's ``EEG_TPU_POD_TIMEOUT_S``.
    ``parent_pid`` (default: this process) arms the child's watchdog, so
    a killed spawner leaves no orphaned rank. ``device`` (``"cpu"`` for
    tests) is passed as ``--device=``; without it the worker runs on the
    card. ``visible_devices`` becomes the child's
    ``CUDA_VISIBLE_DEVICES``: a launcher gives each rank its own card so.
    Returns the ``subprocess.Popen`` (stdout and stderr piped; the last
    stdout line is the worker's JSON result)."""
    import subprocess
    import sys

    if "process_id=" in query:
        raise ValueError(
            "query already carries process_id; pod-assist must not "
            "re-route an explicitly placed member"
        )
    member_query = query
    if "coordinator=" not in query:
        member_query += f"&coordinator={coordinator}"
    if "processes=" not in query:
        member_query += f"&processes={num_processes}"
    member_query += f"&process_id={process_id}"
    env = dict(os.environ)
    for var in _POD_ENV:
        env.pop(var, None)
    # the child imports this package from where the spawner found it
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    if timeout_s is not None:
        env["EEG_TPU_POD_TIMEOUT_S"] = str(timeout_s)
    if visible_devices is not None:
        env["CUDA_VISIBLE_DEVICES"] = str(visible_devices)
    if parent_pid is None:
        parent_pid = os.getpid()
    argv = [sys.executable, "-m", "eeg_dataanalysispackage_tpu_torch.parallel.pod_worker",
            f"--query={member_query}", f"--parent-pid={parent_pid}"]
    if device is not None:
        argv.append(f"--device={device}")
    return subprocess.Popen(argv, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def partition(n_items: int, num_processes: int) -> List[Tuple[int, int]]:
    """Deterministic contiguous partition of ``range(n_items)`` into
    ``num_processes`` blocks, ``[start, stop)`` each: the first ``n_items
    % num_processes`` blocks get one more item (``np.array_split``), so
    each process's rows are one contiguous slice of the global order;
    trailing processes own empty ranges when there are more processes than
    items."""
    if num_processes < 1:
        raise ValueError(f"num_processes must be >= 1, got {num_processes}")
    base, extra = divmod(int(n_items), int(num_processes))
    bounds = [0]
    for p in range(num_processes):
        bounds.append(bounds[-1] + base + (1 if p < extra else 0))
    return [(bounds[p], bounds[p + 1]) for p in range(num_processes)]


@dataclasses.dataclass(frozen=True)
class PodRuntime:
    """One live multi-process bootstrap as the pipeline threads it: the
    hybrid mesh and the resolved process coordinates."""

    mesh: object  # parallel.mesh.Mesh over hosts x local devices
    num_processes: int
    process_id: int
    coordinator: Optional[str] = None


@dataclasses.dataclass
class PodRecording:
    """One recording's metadata-pass products: what its owner needs to
    featurize it, and what every process needs to stay in lockstep,
    without anyone else reading the waveform."""

    rel_path: str
    guessed: int
    eeg_path: str
    header: object  # io.brainvision.Header
    markers: list
    n_samples: int
    channel_indices: List[int]
    plan: object  # ops.device_ingest.IngestPlan


@dataclasses.dataclass
class PodIngestPlan:
    """The global metadata pass: per-recording plans in load order and the
    global targets."""

    entries: List[PodRecording]
    targets: np.ndarray  # (n,) float64, global row order

    def row_counts(self) -> List[int]:
        return [int(e.plan.n_kept) for e in self.entries]

    def host_row_counts(self, num_processes: int) -> List[int]:
        """Kept feature rows per process under :func:`partition`, known to
        every process (the exchange's geometry)."""
        counts = self.row_counts()
        return [int(sum(counts[lo:hi])) for lo, hi in partition(len(counts), num_processes)]


def file_size(fs, path: str) -> int:
    """Byte length of ``path`` by ``fs.size`` where the filesystem can
    stat, else by reading it."""
    sizer = getattr(fs, "size", None)
    if sizer is not None:
        return int(sizer(path))
    return len(fs.read_bytes(path))


def plan_pod_ingest(provider) -> PodIngestPlan:
    """The global metadata pass, run identically on every process: every
    recording's .vhdr/.vmrk text and .eeg byte count, then the run's
    state advanced in load order as ``load_features_device`` advances it
    (channel indices with the stale-index reuse, window validity against
    the true sample count, one balance scan), so each ``IngestPlan`` is
    the single-process run's. A recording with a missing sibling is
    skipped with ``load()``'s log line; an unsupported ``BinaryFormat``
    raises the single-process parse's ``ValueError``."""
    from .. import obs
    from ..epochs.extractor import BalanceState
    from ..io import brainvision
    from ..ops import device_ingest

    prefix, files = provider._resolve_files()
    fs = provider._fs
    balance = BalanceState()
    entries: List[PodRecording] = []
    for rel_path, guessed in files.items():
        eeg_path = prefix + rel_path
        base = os.path.splitext(eeg_path)[0]
        triplet = (base + ".vhdr", base + ".vmrk", eeg_path)
        missing = next((p for p in triplet if not fs.exists(p)), None)
        if missing is not None:
            logger.warning("Did not load %s: No related file found: %s", rel_path, missing)
            continue
        header = brainvision.parse_vhdr(fs.read_text(triplet[0]))
        markers = brainvision.parse_vmrk(fs.read_text(triplet[1]))
        obs.metrics.count("ingest.file_reads", 2)
        dtype = brainvision._BINARY_DTYPES.get(header.binary_format)
        if dtype is None:
            raise ValueError(f"Unsupported BinaryFormat: {header.binary_format}")
        n_samples = (file_size(fs, eeg_path) // dtype.itemsize) // max(1, header.num_channels)
        indices = provider._channel_indices_for_header(header)
        plan = device_ingest.plan_ingest(
            markers, guessed, n_samples, pre=provider.pre, post=provider.post, balance=balance,
        )
        entries.append(PodRecording(
            rel_path=rel_path, guessed=guessed, eeg_path=eeg_path, header=header,
            markers=markers, n_samples=n_samples, channel_indices=indices, plan=plan,
        ))
    targets = (np.concatenate([e.plan.targets for e in entries]) if entries
               else np.zeros((0,), dtype=np.float64))
    return PodIngestPlan(entries=entries, targets=targets)


def local_features(
    provider,
    plan: PodIngestPlan,
    num_processes: int,
    process_id: int,
    featurize_entry: Callable[[PodRecording], torch.Tensor],
    n_feat: int,
) -> torch.Tensor:
    """This process's feature rows on the provider's device: its owned
    contiguous recording block read and featurized in load order by
    ``featurize_entry`` (``OfflineDataProvider.planned_featurizer``: the
    single-process run's launch at the globally planned positions)."""
    lo, hi = partition(len(plan.entries), num_processes)[process_id]
    rows = [featurize_entry(entry).to(torch.float32) for entry in plan.entries[lo:hi]]
    if not rows:
        return torch.zeros((0, n_feat), dtype=torch.float32, device=provider.device)
    return torch.cat(rows)


def exchange_features(
    mesh,
    local_rows: torch.Tensor,
    host_counts: Sequence[int],
    n_feat: int,
    process_id: int,
) -> torch.Tensor:
    """The global (n, n_feat) float32 matrix from every process's row
    block: each block padded to the largest process's count (every
    process derives it from the global plan), one all-gather in process
    order, the padding sliced off and the blocks concatenated, which with
    the contiguous partition is the global row order. The same on every
    process, bit-identical to the unpartitioned run's. ``mesh`` is the
    pod's (the exchange runs over the live bootstrap's group)."""
    from .. import obs
    from ..obs import events
    from . import distributed

    del mesh
    host_counts = [int(c) for c in host_counts]
    n_local = int(local_rows.shape[0])
    if n_local != host_counts[process_id]:
        raise ValueError(
            f"process {process_id} produced {n_local} rows but the "
            f"global plan expected {host_counts[process_id]}; the "
            f"metadata pass and the featurize pass disagree"
        )
    maxn = max(host_counts) if host_counts else 0
    if maxn == 0:
        return torch.zeros((0, n_feat), dtype=torch.float32, device=local_rows.device)
    padded = torch.zeros((maxn, n_feat), dtype=torch.float32, device=local_rows.device)
    padded[:n_local] = local_rows
    with events.span("pod.exchange", rows=maxn, processes=len(host_counts)):
        blocks = distributed.all_gather(padded)
    # this process's wire bytes: its padded block to each of the N-1 peers
    obs.metrics.count("pod.exchange_bytes",
                      padded.numel() * padded.element_size() * (len(host_counts) - 1))
    return torch.cat([block[:count] for block, count in zip(blocks, host_counts)])


def pod_features(
    runtime: PodRuntime,
    provider,
    featurize_entry: Callable[[PodRecording], torch.Tensor],
    n_feat: int,
    plan: Optional[PodIngestPlan] = None,
) -> Tuple[torch.Tensor, np.ndarray]:
    """The whole partitioned ingest of one run: the global metadata pass,
    the owned block's featurize, the exchange. Returns the global
    ``(features on the provider's device, targets)``, the same on every
    process: ``load_features_device``'s return on pod runs. Sets the
    provider's ``timings`` (``parse``: the metadata pass; ``featurize``:
    the owned block, ending in a sync; ``exchange``: the all-gather)."""
    from .. import obs

    t0 = time.perf_counter()
    if plan is None:
        plan = plan_pod_ingest(provider)
    t1 = time.perf_counter()
    local = local_features(provider, plan, runtime.num_processes, runtime.process_id,
                           featurize_entry, n_feat)
    if local.is_cuda:
        torch.cuda.synchronize(local.device)
    t2 = time.perf_counter()
    lo, hi = partition(len(plan.entries), runtime.num_processes)[runtime.process_id]
    obs.metrics.count("pod.recordings_owned", hi - lo)
    obs.metrics.count("pod.recordings_total", len(plan.entries))
    features = exchange_features(runtime.mesh, local,
                                 plan.host_row_counts(runtime.num_processes), n_feat,
                                 runtime.process_id)
    if features.is_cuda:
        torch.cuda.synchronize(features.device)
    provider.timings = {"parse": t1 - t0, "featurize": t2 - t1,
                        "exchange": time.perf_counter() - t2}
    return features, plan.targets
