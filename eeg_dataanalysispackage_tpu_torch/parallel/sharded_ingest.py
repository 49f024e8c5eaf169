"""Sequence-parallel irregular-marker ingest: epoch a time-sharded
recording.

Port of the JAX package's ``parallel/sharded_ingest.py``. A recording is
split over the mesh's time axis into one contiguous block a device, and
each device cuts and featurizes the epochs whose windows start in its
block. A window straddling a block boundary reads its tail from the
right neighbour's first :data:`_SLAB` samples, which are copied to the
shard's device beside its block (the JAX package's ``ppermute`` ring
halo; the last shard's halo is zeros, as Java's copyOfRange zero-pads).
Each shard runs the fused ingest kernel (``ops/ingest_cuda``,
``csrc/ingest_features.cu``) once, on its own stream, at its local
positions; the rows are gathered to the mesh's first device in shard
order and put back in marker order.

Division of labour as in ``ops/device_ingest``: the host plans (marker
validity, the order-dependent balance scan, shard assignment, per-shard
padding); devices touch the waveform.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..epochs.extractor import BalanceState
from ..ops import device_ingest, ingest_cuda
from ..utils import constants
from ..utils.device import host_to_device
from . import mesh as pmesh

#: the halo a shard reads from its right neighbour; a window (pre + skip
#: + epoch_size samples, 787 at the defaults) must fit in it
_SLAB = 1024


@dataclasses.dataclass
class ShardedIngestPlan:
    """Host-side shard assignment for one recording's markers."""

    local_positions: np.ndarray  # (n_shards, cap) int32 positions - shard base
    mask: np.ndarray  # (n_shards, cap) bool
    unsort: np.ndarray  # (n_kept,) row index into the flat (S*cap) output
    targets: np.ndarray  # (n_kept,) float64
    stimulus_indices: np.ndarray  # (n_kept,) int
    # the geometry the plan was computed against; extract() checks it
    block: int = 0
    n_samples: int = 0
    pre: int = constants.PRESTIMULUS_SAMPLES

    def halo_windows(self, window: int) -> int:
        """Kept windows of ``window`` samples that reach past their
        shard's block into the halo."""
        starts = self.local_positions.astype(np.int64) - self.pre
        return int(((starts + window > self.block) & self.mask).sum())


def plan_sharded_ingest(
    markers,
    guessed_number: int,
    n_samples: int,
    n_shards: int,
    block: int,
    pre: int = constants.PRESTIMULUS_SAMPLES,
    balance: Optional[BalanceState] = None,
    capacity_multiple: int = 8,
    valid_n_samples: Optional[int] = None,
) -> ShardedIngestPlan:
    """Assign each kept marker to the shard containing its window start;
    validity and balance come from :func:`device_ingest.plan_ingest` (the
    same host scan). ``valid_n_samples`` judges window validity against
    the true recording length when the staged stream is padded up to the
    shard grid (``n_shards * block``)."""
    base = device_ingest.plan_ingest(
        markers,
        guessed_number,
        valid_n_samples if valid_n_samples is not None else n_samples,
        pre=pre,
        balance=balance,
        capacity_multiple=1,
    )
    kept = base.positions[base.mask].astype(np.int64)
    shard_of = np.clip((kept - pre) // block, 0, n_shards - 1)
    counts = np.bincount(shard_of, minlength=n_shards)
    cap = max(
        capacity_multiple,
        int(-(-max(1, counts.max()) // capacity_multiple)) * capacity_multiple,
    )
    local = np.zeros((n_shards, cap), np.int32)
    mask = np.zeros((n_shards, cap), bool)
    unsort = np.empty(kept.shape[0], np.int64)
    fill = np.zeros(n_shards, np.int64)
    for row, (pos, s) in enumerate(zip(kept, shard_of)):
        j = fill[s]
        local[s, j] = pos - s * block
        mask[s, j] = True
        unsort[row] = s * cap + j
        fill[s] += 1
    return ShardedIngestPlan(
        local_positions=local,
        mask=mask,
        unsort=unsort,
        targets=base.targets,
        stimulus_indices=base.stimulus_indices,
        block=block,
        n_samples=n_samples,
        pre=pre,
    )


def make_sharded_ingest(
    mesh: pmesh.Mesh,
    wavelet_index: int = 8,
    epoch_size: int = 512,
    skip_samples: int = 175,
    feature_size: int = 16,
    pre: int = constants.PRESTIMULUS_SAMPLES,
    axis: str = pmesh.TIME_AXIS,
    donate_stream: bool = False,
):
    """Build ``extract(raw_sharded, resolutions, plan) -> features``.

    ``raw_sharded`` is the (C, T) int16 recording split over ``axis``
    (:func:`stage_recording_int16`; a plain tensor or array is split
    here), T divisible by the axis size, each block at least the halo.
    Returns the (n_kept, C*K) float32 rows in kept-marker order on the
    mesh's first device. ``donate_stream`` is accepted and ignored:
    PyTorch has no buffer donation."""
    del donate_stream
    if pre + skip_samples + epoch_size > _SLAB:
        raise ValueError(
            f"a window of {pre + skip_samples + epoch_size} samples does not fit the "
            f"{_SLAB}-sample halo of the sharded ingest"
        )
    devices = mesh.axis_devices(axis)
    n_shards = len(devices)
    featurize = ingest_cuda.make_cuda_ingest_featurizer(
        wavelet_index=wavelet_index, epoch_size=epoch_size, skip_samples=skip_samples,
        feature_size=feature_size, pre=pre,
    )

    def extract(raw_sharded, resolutions, plan: ShardedIngestPlan) -> torch.Tensor:
        if not isinstance(raw_sharded, pmesh.ShardedArray):
            raw_sharded = stage_recording_int16(raw_sharded, mesh, axis)
        T = raw_sharded.shape[1]
        blocks = raw_sharded.shards
        if len(blocks) != n_shards or len({b.shape[1] for b in blocks}) != 1:
            raise ValueError(f"recording length {T} not divisible by {n_shards} shards")
        if T // n_shards < _SLAB:
            raise ValueError(
                f"per-shard block {T // n_shards} smaller than the "
                f"{_SLAB}-sample halo; use fewer shards"
            )
        if (
            plan.block != T // n_shards
            or plan.n_samples != T
            or plan.local_positions.shape[0] != n_shards
            or plan.pre != pre
        ):
            raise ValueError(
                f"plan geometry (block {plan.block}, T {plan.n_samples}, "
                f"{plan.local_positions.shape[0]} shards, pre {plan.pre}) "
                f"does not match this extractor/recording "
                f"(block {T // n_shards}, T {T}, {n_shards} shards, "
                f"pre {pre}); re-plan with plan_sharded_ingest"
            )
        res = np.asarray(resolutions, np.float32)

        def shard(i, dev):
            block = blocks[i]
            if i + 1 < n_shards:
                # the ring halo: the right neighbour's head, copied over
                halo = blocks[i + 1][:, :_SLAB].to(dev)
            else:
                halo = torch.zeros((block.shape[0], _SLAB), dtype=block.dtype, device=dev)
            ext = torch.cat([block, halo], dim=1)
            return featurize(ext, host_to_device(res, dev), plan.local_positions[i],
                             plan.mask[i])

        rows = pmesh.run_on_shards(devices, shard)
        flat = pmesh.gather(rows, devices[0])
        out = flat[torch.as_tensor(plan.unsort, device=devices[0])]
        if out.is_cuda:
            torch.cuda.current_stream(out.device).synchronize()
        return out

    return extract


def shard_block_for(n_samples: int, n_shards: int, quantum: int = 2048) -> int:
    """Per-shard block length for staging an ``n_samples`` recording over
    ``n_shards`` devices: at least the halo, covering the whole
    recording, bucketed up to a ``quantum`` multiple. The staged length
    is ``n_shards * block``; the padding is semantically free (see
    :func:`plan_sharded_ingest`'s ``valid_n_samples``)."""
    block = max(_SLAB, -(-int(n_samples) // int(n_shards)))
    return -(-block // int(quantum)) * int(quantum)


def stage_recording_int16(signal, mesh: pmesh.Mesh, axis: str = pmesh.TIME_AXIS):
    """A (C, T) int16 recording split over ``axis``: block ``i`` (raw
    int16 bytes, half the float32 transfer) on the axis's ``i``-th
    device."""
    devices = mesh.axis_devices(axis)
    signal = signal.cpu().numpy() if isinstance(signal, torch.Tensor) else np.asarray(signal)
    T = signal.shape[1]
    if T % len(devices):
        raise ValueError(f"recording length {T} not divisible by {len(devices)} shards")
    blocks = np.split(np.asarray(signal, np.int16), len(devices), axis=1)
    return pmesh.ShardedArray([host_to_device(np.ascontiguousarray(b), d)
                               for b, d in zip(blocks, devices)], dim=1)


def stage_recording_local_int16(local_block, mesh: pmesh.Mesh, axis: str = pmesh.TIME_AXIS):
    """The multi-process twin of :func:`stage_recording_int16`, where each
    process stages only its contiguous time block; in one process the
    local block is the whole recording."""
    return stage_recording_int16(local_block, mesh, axis)
