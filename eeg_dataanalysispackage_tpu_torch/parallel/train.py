"""Data-parallel training steps for the flagship P300 model: raw epochs
or the raw int16 stream -> DWT features -> MLP -> loss -> backward ->
update.

Port of the JAX package's ``parallel/train.py``. Every factory returns
``(init_state, step)``; ``step(state, ...) -> (state, loss)`` is
functional (the incoming state is never changed in place), and each
returned step fires the ``device.step`` chaos point once a call
(:func:`_chaos_step`). ``init_state(key)`` takes an integer seed or a
threefry key (``utils/threefry``: the port's own draws, not
``jax.random``'s), or a mapping of arrays: the JAX package's
``init_mlp_params`` dict carried over as it is (:func:`as_params`), so
both packages can run the same steps from the same weights.

The optimizer is optax's ``sgd(learning_rate, momentum, nesterov=True)``
written in torch: ``trace = g + m * trace``, ``update = -lr * (g + m *
trace)``. The loss is the JAX package's masked cross-entropy over the
clipped softmax, averaged over ``max(mask.sum(), 1)`` rows.

With a mesh (``parallel/mesh.py``) a step is data-parallel over the
mesh's data axis: the batch arrives split (``shard_batch_with_mask``,
:func:`stage_batch`, ``io.staging.prefetch(mesh=)``) or is split here,
each shard's forward and backward run on its device (on that device's
current stream), the shard gradients and losses are added in shard order
on the first device (the port's all-reduce; XLA's psum adds in its own
order), and the update is applied there, the parameters going to every
shard at the next step.

The raw-stream steps run the fused ingest kernel (``ops/ingest_cuda``,
``csrc/ingest_features.cu``) on the card and its plain version on the
CPU: :func:`make_raw_train_step` through the regular-train featurizer
(the JAX package's ``bank`` formulation reaches its bank128 Pallas kernel
there), :func:`make_irregular_train_step` at an ingest plan's padded
positions, and :func:`make_irregular_bank_train_step` at concrete
positions planned once when the step is built, at ``bank128`` (the f32
instantiation) or ``bank128_bf16`` (the bf16 instantiation, K2-bf16).

PyTorch has no buffer donation: every ``donate_*`` argument is accepted
and ignored.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..obs import chaos
from ..ops import dwt
from ..utils import constants, threefry
from ..utils.device import host_to_device, resolve_device
from . import mesh as pmesh

#: the JAX package's bank-kernel modes
BANK_MODES = ("bank128", "bank128_bf16")


def _chaos_step(step):
    """The ``device.step`` chaos point around a step a factory returns
    (never around the inner step another factory composes: that one is
    reached through ``__wrapped__``, :func:`_raw_step`)."""

    @functools.wraps(step)
    def wrapped(state, *args, **kwargs):
        chaos.maybe_fire("device.step")
        return step(state, *args, **kwargs)

    return wrapped


def _raw_step(step):
    """The unwrapped form of a factory-returned step."""
    return getattr(step, "__wrapped__", step)


def _tensor(a, device, dtype=None) -> torch.Tensor:
    """``a`` (numpy, a list or a tensor) as a tensor on ``device``."""
    t = a if isinstance(a, torch.Tensor) else host_to_device(np.asarray(a), device)
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def init_mlp_params(key, sizes=(48, 64, 2), dtype=torch.float32,
                    device=None) -> Dict[str, torch.Tensor]:
    """He-normal weights and zero biases, ``w{i}`` (n_in, n_out) and
    ``b{i}`` (n_out,), drawn from ``key`` (a seed or a threefry key)
    folded with the layer index on ``device`` (None: the card)."""
    dev = resolve_device(device)
    key = threefry.prng_key(int(key)) if isinstance(key, (int, np.integer)) else key
    params = {}
    for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = threefry.normal(threefry.fold_in(key, i), (n_in, n_out), device=dev)
        params[f"w{i}"] = (w * float(np.sqrt(np.float32(2.0 / n_in)))).to(dtype)
        params[f"b{i}"] = torch.zeros((n_out,), dtype=dtype, device=dev)
    return params


def as_params(params: Mapping, device) -> Dict[str, torch.Tensor]:
    """Carried weights (the JAX package's ``init_mlp_params`` dict of
    arrays, or tensors) as float32 tensors on ``device``."""
    return {k: (v.to(device, torch.float32).clone() if isinstance(v, torch.Tensor)
                else host_to_device(np.array(v, np.float32), device))
            for k, v in params.items()}


def forward(params: Dict[str, torch.Tensor], features: torch.Tensor) -> torch.Tensor:
    """(B, F) features -> (B, 2) class probabilities."""
    x = features
    n_layers = len(params) // 2
    for i in range(n_layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            x = torch.relu(x)
    return torch.softmax(x, dim=-1)


def extract_features(epochs: torch.Tensor) -> torch.Tensor:
    """(B, C, T) raw epochs -> (B, C*16) normalized DWT features
    (``ops/dwt.epoch_features``)."""
    return dwt.epoch_features(epochs)


def forward_step(params: Dict[str, torch.Tensor], epochs: torch.Tensor) -> torch.Tensor:
    """Raw epochs -> P(target)."""
    return forward(params, extract_features(epochs))[:, 0]


def _shards(a, devices) -> list:
    """``a``'s rows split evenly over ``devices`` (zero rows padded to a
    multiple), or a sharded array's own shards."""
    if isinstance(a, pmesh.ShardedArray):
        return a.shards
    pad = (-a.shape[0]) % len(devices)
    if pad:
        a = torch.cat([a, a.new_zeros((pad, *a.shape[1:]))])
    return [c.to(d) for c, d in zip(torch.chunk(a, len(devices)), devices)]


def make_feature_train_step(
    mesh=None,
    learning_rate: float = 0.05,
    momentum: float = 0.9,
    feature_dim: int = 48,
    donate_state: bool = True,
    device=None,
):
    """(init_state, step) on precomputed (B, feature_dim) features: the
    MLP (feature_dim, 64, 2) half of the raw steps. ``step(state,
    features, labels, mask)``; the state lives on ``device`` (None: the
    card), or on the mesh's first device."""
    del donate_state
    dev = mesh.first_device if mesh is not None else resolve_device(device)
    devices = mesh.axis_devices(pmesh.DATA_AXIS if pmesh.DATA_AXIS in mesh.axis_names
                                else mesh.axis_names[0]) if mesh is not None else [dev]
    neg_lr = float(np.float32(-learning_rate))
    m = float(np.float32(momentum))

    def init_state(key):
        if isinstance(key, Mapping):
            params = as_params(key, dev)
        else:
            params = init_mlp_params(key, sizes=(feature_dim, 64, 2), device=dev)
        return {"params": params,
                "opt": {"trace": {k: torch.zeros_like(v) for k, v in params.items()}}}

    def step(state, features, labels, mask):
        params = state["params"]
        names = list(params)
        parts = [_shards(a if isinstance(a, pmesh.ShardedArray) else _tensor(a, dev, torch.float32),
                         devices) for a in (features, labels, mask)]
        total = torch.clamp(pmesh.sum_in_order([mk.sum() for mk in parts[2]], dev), min=1.0)
        grads, losses = [], []
        for x, y, mk in zip(*parts):
            d = x.device
            p = {k: params[k].to(d).detach().requires_grad_(True) for k in names}
            with torch.enable_grad():
                probs = forward(p, x.to(torch.float32))
                onehot = torch.stack([y, 1.0 - y], dim=1)
                per_example = -torch.sum(onehot * torch.log(torch.clamp(probs, 1e-7, 1.0)),
                                         dim=1) * mk
                loss = per_example.sum() / total.to(d)
                grads.append(torch.autograd.grad(loss, [p[k] for k in names]))
            losses.append(loss.detach())
        loss = pmesh.sum_in_order(losses, dev)
        new_params, new_trace = {}, {}
        with torch.no_grad():
            for j, k in enumerate(names):
                g = pmesh.sum_in_order([gs[j] for gs in grads], dev)
                trace = g + m * state["opt"]["trace"][k]
                new_trace[k] = trace
                new_params[k] = params[k] + neg_lr * (g + m * trace)
        return {"params": new_params, "opt": {"trace": new_trace}}, loss

    return init_state, _chaos_step(step)


def make_train_step(
    mesh=None,
    learning_rate: float = 0.05,
    momentum: float = 0.9,
    donate_state: bool = True,
    donate_epochs: bool = False,
    device=None,
):
    """(init_state, step) for the full pipeline: ``step(state, epochs,
    labels, mask)`` over (B, C, T) float32 epochs, featurized by
    :func:`extract_features` (shard by shard for sharded epochs)."""
    del donate_epochs
    init_state, feat_step = make_feature_train_step(mesh, learning_rate, momentum,
                                                    donate_state=donate_state, device=device)
    feat_step = _raw_step(feat_step)

    def step(state, epochs, labels, mask):
        if isinstance(epochs, pmesh.ShardedArray):
            feats = epochs.map(extract_features)
        else:
            feats = extract_features(_tensor(epochs, state["params"]["w0"].device,
                                             torch.float32))
        return feat_step(state, feats, labels, mask)

    return init_state, _chaos_step(step)


def make_compact_train_step(
    mesh=None,
    learning_rate: float = 0.05,
    momentum: float = 0.9,
    wavelet_index: int = 8,
    epoch_size: int = 512,
    feature_size: int = 16,
    n_channels: int = 3,
    donate_state: bool = True,
    donate_epochs: bool = False,
    device=None,
):
    """(init_state, step) over compact epochs: ``step(state, epochs_512,
    labels, mask)`` with (B, C, epoch_size) analysis windows only; a batch
    of another width raises."""
    del donate_epochs
    init_state, feat_step = make_feature_train_step(
        mesh, learning_rate, momentum, feature_dim=n_channels * feature_size,
        donate_state=donate_state, device=device)
    feat_step = _raw_step(feat_step)

    def featurize(ep):
        return dwt.compact_epoch_features(ep, wavelet_index, epoch_size, feature_size)

    def step(state, epochs_512, labels, mask):
        if isinstance(epochs_512, pmesh.ShardedArray):
            feats = epochs_512.map(featurize)
        else:
            feats = featurize(_tensor(epochs_512, state["params"]["w0"].device, torch.float32))
        return feat_step(state, feats, labels, mask)

    return init_state, _chaos_step(step)


def make_raw_train_step(
    stride: int,
    n_epochs: int,
    mesh=None,
    learning_rate: float = 0.05,
    momentum: float = 0.9,
    formulation: str = "auto",
    donate_state: bool = True,
    device=None,
):
    """Train straight from a regular stimulus train in the int16 stream:
    ``step(state, raw_i16, resolutions, labels, mask, first_position)``,
    the fused ingest kernel at ``first_position + k*stride`` for every
    ``formulation`` name (``ops/device_ingest.make_regular_ingest_featurizer``;
    the JAX package's ``bank`` is K2's first call site), then the feature
    step. The stream is read where the state lives."""
    from ..ops import device_ingest

    dev = mesh.first_device if mesh is not None else resolve_device(device)
    ing = device_ingest.make_regular_ingest_featurizer(stride, n_epochs,
                                                        formulation=formulation, device=dev)
    init_state, feat_step = make_feature_train_step(mesh, learning_rate, momentum,
                                                    donate_state=donate_state, device=dev)
    feat_step = _raw_step(feat_step)

    def step(state, raw_i16, resolutions, labels, mask, first_position):
        d = state["params"]["w0"].device
        feats = ing(_tensor(raw_i16, d), _tensor(resolutions, d, torch.float32),
                    int(first_position))
        return feat_step(state, feats, labels, mask)

    step.formulation = ing.formulation
    return init_state, _chaos_step(step)


def make_irregular_train_step(
    mesh=None,
    learning_rate: float = 0.05,
    momentum: float = 0.9,
    chunk_epochs: int = 32768,
    donate_state: bool = True,
    device=None,
):
    """Train straight from the int16 stream with irregular markers:
    ``step(state, raw_i16, resolutions, positions, mask, labels)`` over an
    ``IngestPlan``'s capacity-padded ``positions``/``mask`` (labels padded
    to the same capacity); the fused ingest kernel gives padded rows zero
    features and the loss masks them out. ``chunk_epochs`` (the JAX
    package's block-featurizer chunk) is accepted: one launch takes any
    count."""
    from ..ops import ingest_cuda

    del chunk_epochs
    featurize = ingest_cuda.make_cuda_ingest_featurizer()
    init_state, feat_step = make_feature_train_step(mesh, learning_rate, momentum,
                                                    donate_state=donate_state, device=device)
    feat_step = _raw_step(feat_step)

    def step(state, raw_i16, resolutions, positions, mask, labels):
        d = state["params"]["w0"].device
        mask = _host(mask)
        feats = featurize(_tensor(raw_i16, d), _tensor(resolutions, d, torch.float32),
                          _host(positions), mask)
        return feat_step(state, feats, labels, _tensor(mask.astype(np.float32), d))

    return init_state, _chaos_step(step)


def make_irregular_bank_train_step(
    positions,
    mesh=None,
    learning_rate: float = 0.05,
    momentum: float = 0.9,
    n_channels: int = 3,
    chunk: int = 65536,
    tile_b: int = 32,
    mode: str = "bank128",
    wavelet_index: int = 8,
    epoch_size: int = 512,
    skip_samples: int = 175,
    feature_size: int = 16,
    pre: Optional[int] = None,
    donate_state: bool = True,
    device=None,
):
    """Irregular raw-stream training at concrete marker ``positions``
    (K2's second call site): the window starts are planned once, here,
    and ``step(state, raw_i16, resolutions, labels)`` (labels in marker
    order) launches the fused ingest kernel at them, at ``bank128`` the
    f32 instantiation and at ``bank128_bf16`` the bf16 one (K2-bf16), then
    the feature step with an MLP of ``n_channels * feature_size`` inputs.
    ``chunk``/``tile_b`` (the JAX package's VMEM tile plan) are accepted:
    the kernel needs no tile plan. Positions must be valid (``position -
    pre >= 0``), as the ingest planner guarantees."""
    from ..ops import ingest_cuda

    del chunk, tile_b
    if mode not in BANK_MODES:
        raise ValueError(
            f"make_irregular_bank_train_step supports {BANK_MODES}; got {mode!r}"
        )
    pre = constants.PRESTIMULUS_SAMPLES if pre is None else pre
    dwt.check_feature_size(wavelet_index, epoch_size, feature_size)
    starts = np.asarray(positions, dtype=np.int64) - pre
    if starts.size and starts.min() < 0:
        raise ValueError(f"window starts must be >= 0; got {int(starts.min())}")
    starts = starts.astype(np.int32)
    precision = "bf16" if mode == "bank128_bf16" else "f32"
    n = starts.shape[0]
    init_state, feat_step = make_feature_train_step(
        mesh, learning_rate, momentum, feature_dim=n_channels * feature_size,
        donate_state=donate_state, device=device)
    feat_step = _raw_step(feat_step)
    planned: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def step(state, raw_i16, resolutions, labels):
        d = state["params"]["w0"].device
        raw = _tensor(raw_i16, d)
        if raw.shape[0] != n_channels:
            raise ValueError(
                f"bank train step built for {n_channels} channels; got raw with {raw.shape[0]}"
            )
        if d not in planned:
            planned[d] = (host_to_device(starts, d),
                          dwt.kernel_operator(wavelet_index, epoch_size, feature_size, d))
        starts_t, operator = planned[d]
        feats = ingest_cuda.ingest_features(
            raw, _tensor(resolutions, d, torch.float32), starts_t, operator, pre,
            skip_samples, precision, epoch_size, feature_size)
        return feat_step(state, feats, labels, torch.ones(n, dtype=torch.float32, device=d))

    return init_state, _chaos_step(step)


def make_decode_feature_stage(
    wavelet_index: int = 8,
    epoch_size: int = 512,
    skip_samples: int = 175,
    feature_size: int = 16,
    donate_stream: bool = True,
    device=None,
):
    """The overlap path's staging function: ``(raw_i16, resolutions,
    positions, mask, labels) -> (features, labels, mask)`` on ``device``
    (None: the card), the stream staged and the fused ingest kernel
    launched inside the call: the ``stage_fn`` of ``io.staging.prefetch``.
    ``labels`` are padded to the plan's capacity."""
    from ..ops import ingest_cuda

    del donate_stream
    dev = resolve_device(device)
    featurize = ingest_cuda.make_cuda_ingest_featurizer(
        wavelet_index=wavelet_index, epoch_size=epoch_size, skip_samples=skip_samples,
        feature_size=feature_size)

    def stage_one(item):
        raw, resolutions, positions, mask, labels = item
        feats = featurize(_tensor(raw, dev), _tensor(resolutions, dev, torch.float32),
                          _host(positions), _host(mask))
        return (feats, host_to_device(np.asarray(_host(labels), np.float32), dev),
                host_to_device(np.asarray(_host(mask), np.float32), dev))

    return stage_one


def train_over_recordings(
    state,
    step,
    recordings,
    wavelet_index: int = 8,
    feature_size: int = 16,
    buffer_size=None,
    overlap: bool = True,
    donate_stream: bool = True,
):
    """Train over recordings with ingest and compute overlapped: with
    ``overlap`` recording K+1's staging and kernel run on
    ``io.staging.prefetch``'s producer thread (its own CUDA stream on a
    card) while recording K's step runs here; without, the same staging
    function runs serially (the same epochs, order and losses).
    ``recordings`` yields ``(raw_i16 (C, S), resolutions, positions,
    mask, labels)``; ``step`` is a :func:`make_feature_train_step` step,
    run where ``state`` lives. Returns ``(state, losses)``."""
    from ..io import staging

    dev = state["params"]["w0"].device
    stage_one = make_decode_feature_stage(wavelet_index=wavelet_index,
                                          feature_size=feature_size,
                                          donate_stream=donate_stream, device=dev)
    source = iter(recordings)
    stream = (staging.prefetch(source, device=dev, stage_fn=stage_one,
                               buffer_size=buffer_size)
              if overlap else (stage_one(item) for item in source))
    losses = []
    for feats, labels, mask_f in stream:
        state, loss = step(state, feats, labels, mask_f)
        losses.append(float(loss))
    return state, losses


def stage_batch(epochs: np.ndarray, labels: np.ndarray, mesh):
    """Pad and split a host batch over the mesh's data axis; returns the
    epochs, the labels and the validity mask, each a ``ShardedArray``."""
    return pmesh.shard_batch_with_mask(mesh, epochs, labels)
