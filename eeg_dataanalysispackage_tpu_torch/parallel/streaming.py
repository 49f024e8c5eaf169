"""Sequence-parallel streaming front end for continuous EEG.

Port of the JAX package's ``parallel/streaming.py`` (BASELINE.json config
5: "Streaming FFT bandpass + DWT on 256ch@1kHz continuous EEG").
Continuous multi-channel recordings are featurized blockwise with the
time axis sharded over a mesh: each device holds a contiguous block, and
the windows that straddle a block boundary read their tail from the
right neighbour's block: copied between the devices of one process (the
pattern of ``parallel/sharded_ingest.py``), and across a process
boundary by one point-to-point exchange (``distributed.exchange_halo``).

Per window: the band-passed eegdsp DWT coefficient prefix, then an L2
normalize. The zero-phase FFT band-pass is folded into the cascade
matrix at build time, in float64 (:func:`filtered_cascade_kernel`), so
each window is one contraction with that matrix: ``torch.matmul`` over
(windows x channels), as the JAX package leaves it to XLA (it has no
Pallas kernel here).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..ops import dwt
from ..ops.signal import bandpass_mask
from ..utils.device import host_to_device, resolve_device
from . import distributed, mesh as pmesh


@functools.lru_cache(maxsize=None)
def filtered_cascade_kernel(
    window: int,
    wavelet_index: int,
    feature_count: int,
    fs: float,
    band: tuple,
) -> np.ndarray:
    """(window, feature_count) float64 matrix with the band-pass folded in.

    The zero-phase band-pass (a real rfft mask) is a symmetric circulant
    operator B and the coefficient prefix is the cascade matrix K, so
    ``irfft(rfft(w) * mask) @ K == w @ (B @ K)``; B @ K is computed once,
    in float64, in the JAX package's order."""
    mask = np.asarray(bandpass_mask(window, fs, *band), dtype=np.float64)
    kernel = dwt.cascade_matrix(wavelet_index, window, feature_count)
    return np.fft.irfft(np.fft.rfft(kernel, axis=0) * mask[:, None], n=window, axis=0)


def _scale_block(x: torch.Tensor, resolutions: Optional[torch.Tensor]) -> torch.Tensor:
    """The one cast and scale every streaming path runs: float32 (int16
    ships raw), then the per-channel resolutions when given."""
    x = x.to(torch.float32)
    if resolutions is not None:
        x = x * resolutions.to(x.device)[:, None]
    return x


def _windowed_pipeline(ext: torch.Tensor, window: int, stride: int,
                       kernel: torch.Tensor) -> torch.Tensor:
    """(C, B + window - stride) extended float32 block -> (B // stride,
    C * feature_count): windows every ``stride`` samples, each contracted
    with the composed kernel, rows L2-normalized. Shared by the sharded
    extractor and the blocked iterator so the two cannot diverge."""
    C = ext.shape[0]
    wins = ext.unfold(1, window, stride)  # (C, W, window), a view
    coeffs = torch.matmul(wins.transpose(0, 1), kernel.to(ext.device))  # (W, C, K)
    return dwt.safe_l2_normalize(coeffs.reshape(coeffs.shape[0], C * kernel.shape[1]))


def _time_shards(mesh: pmesh.Mesh, axis: str) -> int:
    """The recording's shard count: the axis's devices, times the
    processes on a mesh that spans them (process-major)."""
    return len(mesh.axis_devices(axis)) * mesh.process_count


def make_streaming_extractor(
    mesh: pmesh.Mesh,
    window: int = 512,
    stride: int = 256,
    fs: float = 1000.0,
    band: tuple = (0.5, 40.0),
    wavelet_index: int = 8,
    feature_count: int = 16,
    axis: str = pmesh.TIME_AXIS,
    resolutions=None,
):
    """Build ``extract(signal) -> (n_windows, C * feature_count)`` with the
    (C, T) recording's time axis sharded over ``axis`` of ``mesh`` (over
    the processes too, process-major, on a mesh that spans them).

    ``signal`` is staged (:func:`stage_recording`,
    :func:`stage_recording_local`) or a host array or tensor, staged here.
    T must divide by the shard count and each block by ``stride``; windows
    whose tail runs past the recording's end wrap into the first block
    (periodic over the ring), as in the JAX package. int16 recordings may
    be staged raw and scaled on the device by per-channel
    ``resolutions``. The rows come back in window order on this process's
    first device, every process's rows on every process."""
    if not 0 < stride <= window:
        raise ValueError(f"stride {stride} must be in (0, window={window}]")
    kernel_np = filtered_cascade_kernel(window, wavelet_index, feature_count, fs, tuple(band))
    devices = mesh.axis_devices(axis)
    n_shards = _time_shards(mesh, axis)
    res_np = None if resolutions is None else np.asarray(resolutions, dtype=np.float32)
    kernels = {d: host_to_device(kernel_np.astype(np.float32), d) for d in set(devices)}
    res_t = ({d: host_to_device(res_np, d) for d in set(devices)} if res_np is not None
             else None)
    halo = window - stride

    def extract(signal) -> torch.Tensor:
        staged = signal if isinstance(signal, pmesh.ShardedArray) else None
        T = staged.shape[1] if staged is not None else signal.shape[-1]
        if T % n_shards != 0:
            raise ValueError(
                f"recording length {T} not divisible by mesh axis "
                f"{axis!r} size {n_shards}"
            )
        block = T // n_shards
        if block % stride != 0:
            raise ValueError(
                f"per-shard block length {block} not a multiple of "
                f"stride {stride}"
            )
        if halo > block:
            raise ValueError(
                f"halo {halo} exceeds block length {block}; "
                f"use fewer shards or a smaller window"
            )
        if staged is None:
            staged = stage_recording(signal, mesh, axis)
        blocks = staged.shards
        # the right neighbour's head of the last local block: the next
        # process's first block (the ring wraps to process 0), or on one
        # process this process's own first block
        tail = blocks[0][:, :halo]
        if staged.across_processes:
            tail = distributed.exchange_halo(tail)

        def shard(i, dev):
            nxt = blocks[i + 1][:, :halo] if i + 1 < len(blocks) else tail
            ext = torch.cat([blocks[i], nxt.to(dev)], dim=1)
            return _windowed_pipeline(
                _scale_block(ext, None if res_t is None else res_t[dev]), window, stride,
                kernels[dev])

        rows = pmesh.run_on_shards(devices, shard)
        out = pmesh.ShardedArray(rows, 0, staged.process_count, staged.process_id).gather()
        if out.is_cuda:
            torch.cuda.current_stream(out.device).synchronize()
        return out

    return extract


def iter_blocked_features(
    signal: np.ndarray,
    window: int = 512,
    stride: int = 256,
    block: int = 8192,
    fs: float = 1000.0,
    band: tuple = (0.5, 40.0),
    wavelet_index: int = 8,
    feature_count: int = 16,
    resolutions=None,
    device=None,
):
    """Bounded-memory streaming on one device: yield feature blocks.

    The host feeds ``block``-sample chunks (plus the ``window - stride``
    halo read from the next chunk) to the device, so device memory is
    O(block) whatever T. Windows are every ``stride`` samples with the
    whole window in bounds: ``(T - window) // stride + 1`` rows in all,
    no periodic wrap. int16 inputs ship raw and are scaled on the device
    by ``resolutions`` (default 1.0); other dtypes are cast to float32 a
    chunk at a time. Chunk i+1 is staged while chunk i's rows are still
    being computed (the rows are read back one chunk behind). ``device``:
    None is the card. Yields (n_rows, C * feature_count) float32 numpy
    arrays; :func:`blocked_features` concatenates them."""
    if not 0 < stride <= window:
        raise ValueError(f"stride {stride} must be in (0, window={window}]")
    if block % stride != 0:
        raise ValueError(f"block {block} must be a multiple of stride {stride}")
    signal = np.asarray(signal)  # no copy or cast: may be a memmap view
    C, T = signal.shape
    if T < window:
        return
    dev = resolve_device(device)
    halo = window - stride
    kernel = host_to_device(
        filtered_cascade_kernel(window, wavelet_index, feature_count, fs,
                                tuple(band)).astype(np.float32), dev)
    ship_raw = signal.dtype == np.int16
    res = host_to_device(np.ones(C, np.float32) if resolutions is None
                         else np.asarray(resolutions, dtype=np.float32), dev)
    n_windows = (T - window) // stride + 1
    emitted = 0
    pending = None  # (device rows, take): one chunk of look-ahead
    for start in range(0, T, block):
        take = min(block // stride, n_windows - emitted)
        if take <= 0:
            break
        chunk = signal[:, start: start + block + halo]
        chunk = np.asarray(chunk, dtype=np.int16 if ship_raw else np.float32)
        if chunk.shape[1] < block + halo:  # the final chunk: zero-padded
            chunk = np.pad(chunk, ((0, 0), (0, block + halo - chunk.shape[1])))
        feats = _windowed_pipeline(_scale_block(host_to_device(np.ascontiguousarray(chunk), dev),
                                                res), window, stride, kernel)
        emitted += take
        if pending is not None:
            yield pending[0][: pending[1]].cpu().numpy()
        pending = (feats, take)
    if pending is not None:
        yield pending[0][: pending[1]].cpu().numpy()


def blocked_features(signal: np.ndarray, **kwargs) -> np.ndarray:
    """Concatenated :func:`iter_blocked_features` output:
    ((T - window) // stride + 1, C * feature_count) float32."""
    parts = list(iter_blocked_features(signal, **kwargs))
    if not parts:
        C = np.asarray(signal).shape[0]
        f = kwargs.get("feature_count", 16)
        return np.zeros((0, C * f), dtype=np.float32)
    return np.concatenate(parts)


def stage_recording(signal, mesh: pmesh.Mesh, axis: str = pmesh.TIME_AXIS,
                    dtype=torch.float32) -> pmesh.ShardedArray:
    """A (C, T) recording time-sharded over ``axis``: block ``i`` on the
    axis's ``i``-th device, cast to ``dtype`` (``torch.int16`` ships raw
    int16 bytes, half the float32 transfer). On a mesh that spans
    processes every process passes the whole recording and keeps its own
    blocks."""
    signal = signal.cpu().numpy() if isinstance(signal, torch.Tensor) else np.asarray(signal)
    n_shards = _time_shards(mesh, axis)
    T = signal.shape[1]
    if T % n_shards:
        raise ValueError(f"recording length {T} not divisible by {n_shards} shards")
    n_local = n_shards // mesh.process_count
    local = signal[:, mesh.process_id * (T // mesh.process_count):][:, :T // mesh.process_count]
    devices = mesh.axis_devices(axis)
    blocks = np.split(local, n_local, axis=1)
    return pmesh.ShardedArray(
        [host_to_device(torch.as_tensor(np.ascontiguousarray(b)).to(dtype), d)
         for b, d in zip(blocks, devices)], 1, mesh.process_count, mesh.process_id)


def stage_recording_local(local_block, mesh: pmesh.Mesh, axis: str = pmesh.TIME_AXIS,
                          dtype=np.float32) -> pmesh.ShardedArray:
    """Multi-process staging: this process's contiguous (C, T_local) time
    block over its devices on ``axis``; the global recording is the
    processes' blocks in process order, and the extractor's halo crosses
    process boundaries. In one process this is :func:`stage_recording`.
    ``dtype=np.int16`` ships raw recording bytes."""
    from . import distributed

    local = (local_block.cpu().numpy() if isinstance(local_block, torch.Tensor)
             else np.asarray(local_block))
    return distributed.stage_local(local.astype(dtype, copy=False), mesh, axis, dim=1)
