"""Population training engines: P members on one leading member axis.

Port of the JAX package's ``parallel/population.py``. Four engines, each
built on the per-member step the sequential runs take, so a member's
trajectory is the sequential one, batched:

- :func:`train_linear_population`: logreg and svm (MLlib-SGD) with the
  members' weights a (P, d) tensor on the run's device. A single-fold
  population shares the gathered train rows; a multi-fold one keeps the
  full matrix and a (P, n) train-row mask per member. An ``fe_sweep=``
  population gives every member its own (n, d) matrix, a (P, n, d)
  stack: its margins and gradients are
  batched products of each member's matrix with its own weights. Step sizes, regs,
  seeds and class weights are (P,) device tensors; every member's step
  scalars are the float32 values ``models/sgd._step`` computes. A member
  that meets MLlib's convergence test is frozen on the device, as the
  JAX scan's carry freezes; the engine reads the flags back only every
  :data:`POLL_EVERY` iterations, and stops early once all members have
  converged (frozen members make that invisible in the result).
  Mini-batch members draw the masks of a block of iterations for all
  members in one pass over a (T, P) grid of keys
  (``sgd.mini_batch_masks``), each row bit-equal to the member's own
  ``sgd.mini_batch_mask``; multi-fold members draw over all n rows, as
  the JAX package keys them.
- :func:`train_linear_population_sharded`: the batched linear engine with
  the member axis split over a mesh axis (``parallel/mesh.py``): the
  members padded to a multiple of the axis with inert members (an
  all-zero sample mask: no update ever fires, the weights stay zero),
  each device's block of members trained by
  :func:`train_linear_population` on its own device and stream,
  the weights gathered in member order to the mesh's first device. Over
  a pod's hybrid mesh (``hosts`` outermost) each process trains its
  contiguous block of the padded members on its own devices, and one
  all-gather in process order gives every process all of them.
- :func:`train_linear_population_looped`: the same per-member invocation,
  one member at a time (a single-fold member is ``sgd.train_linear``
  exactly, a multi-fold one ``train_linear`` with its fold's
  ``sample_mask``): the baseline and the fallback.
- :func:`train_nn_population`: the network's members stacked on a member
  axis and run through its forward as explicitly batched layers (every
  product a batched matmul; ``torch.func.vmap`` would cost a multi-second
  import of ``torch._dynamo`` at its first call in a process); each
  member inits from its own seed and draws its dropout masks from its
  own key (the member axis never enters the threefry counter), and one
  updater steps all members with a (P,) tensor of learning rates.

Batching turns the member matvecs into matrix products, whose sums may
round in another order: member weights agree with the looped engine to
float32 roundoff, and thresholded predictions (the statistics) are equal
on real feature rows, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..models import sgd
from ..utils import threefry

#: iterations between the batched linear engine's convergence polls (its
#: only host read-backs)
POLL_EVERY = 64
#: elements of one block of mini-batch draws (T x P x n int64 words)
_DRAW_BLOCK = 1 << 22


class PopulationVmapUnsupported(ValueError):
    """This member set cannot train as one batched program (nn
    pretraining, a value-function optimizer, ``backprop=false``, a
    multi-fold nn population); the caller trains it looped."""


def _weight_arrays(config, n_members, weight_pos, weight_neg):
    """Per-member class weights and the engine-wide ``weighted`` flag: a
    cost axis on any member weights every member."""
    wp = ([float(w) for w in weight_pos] if weight_pos is not None
          else [float(config.weight_pos)] * n_members)
    wn = ([float(w) for w in weight_neg] if weight_neg is not None
          else [float(config.weight_neg)] * n_members)
    weighted = any(w != 1.0 for w in wp + wn)
    return wp, wn, weighted


def train_linear_population(
    features: torch.Tensor,
    labels,
    config: sgd.SGDConfig,
    step_sizes: Sequence[float],
    reg_params: Sequence[float],
    seeds: Sequence[int],
    masks: Optional[np.ndarray],
    weight_pos: Optional[Sequence[float]] = None,
    weight_neg: Optional[Sequence[float]] = None,
) -> tuple:
    """Train P MLlib-SGD members at once on ``features``' device.

    ``features`` (n, d) and ``labels`` (n,) are the shared rows: the
    gathered train split when ``masks`` is None, else the full matrix
    with ``masks`` (P, n) selecting each member's train rows. Features of
    shape (P, n, d) are one matrix per member over the same rows and
    labels. ``config``
    gives the shared iteration count, loss, mini-batch fraction and
    convergence tolerance. Returns the members' carries in member order:
    ``(weights (P, d) float32, converged (P,) bool, n_updates (P,)
    int32)``, the updates each member made before it froze."""
    if config.loss not in ("logistic", "hinge"):
        raise ValueError(f"unknown loss {config.loss!r}")
    dev = features.device
    x = features.to(torch.float32)
    y = torch.as_tensor(labels, device=dev).to(torch.float32)
    n, d = x.shape[-2:]
    stacked = x.dim() == 3
    p = len(list(seeds))
    f32 = dict(dtype=torch.float32, device=dev)
    steps = torch.tensor([float(np.float32(v)) for v in step_sizes], **f32)
    regs = torch.tensor([float(np.float32(v)) for v in reg_params], **f32)
    seeds_t = torch.tensor([int(s) for s in seeds], dtype=torch.int64, device=dev)
    wp, wn, weighted = _weight_arrays(config, p, weight_pos, weight_neg)
    class_w = None
    if weighted:
        class_w = (y * torch.tensor(wp, **f32)[:, None]
                   + (1.0 - y) * torch.tensor(wn, **f32)[:, None])
    base = None if masks is None else torch.as_tensor(masks, device=dev).to(torch.float32)
    sampled = config.mini_batch_fraction < 1.0
    count = (base.sum(dim=1) if base is not None
             else torch.full((p,), float(n), **f32))
    tol = float(np.float32(config.convergence_tol))
    y_signed = 2.0 * y - 1.0

    w = torch.zeros((p, d), **f32)
    converged = torch.zeros(p, dtype=torch.bool, device=dev)
    n_updates = torch.zeros(p, dtype=torch.int32, device=dev)
    total = int(config.num_iterations)
    # sqrt(t) of every iteration, made on the device (no copy to wait on)
    sqrt_t = torch.sqrt(torch.arange(1, total + 1, **f32))
    block = max(1, min(POLL_EVERY, _DRAW_BLOCK // max(1, p * n)))
    draws = None
    for t in range(1, total + 1):
        mask = base
        if sampled:
            i = (t - 1) % block
            if i == 0:
                ts = torch.arange(t, min(t + block, total + 1), dtype=torch.int64, device=dev)
                draws = sgd.mini_batch_masks(seeds_t, ts, n, config.mini_batch_fraction)
            mask = draws[i] if base is None else base * draws[i]
            count = mask.sum(dim=1)
        if stacked:
            margin = torch.bmm(x, w.unsqueeze(2)).squeeze(2)  # (P, n)
        else:
            margin = w @ x.T  # (P, n)
        if config.loss == "logistic":
            mult = torch.sigmoid(margin) - y
        else:
            mult = torch.where(y_signed * margin < 1.0, -y_signed,
                               torch.zeros((), device=dev))
        if class_w is not None:
            mult = mult * class_w
        if mask is not None:
            mult = mult * mask
        if stacked:
            g = torch.bmm(mult.unsqueeze(1), x).squeeze(1)  # (P, d)
        else:
            g = mult @ x  # (P, d)
        step_t = steps / sqrt_t[t - 1]
        updated = count > 0
        scale = torch.where(updated, 1.0 / torch.clamp(count, min=1.0), torch.zeros_like(count))
        decay = torch.where(updated, 1.0 - step_t * regs, torch.ones_like(count))
        w_cand = w * decay[:, None] - (step_t * scale)[:, None] * g
        if tol > 0.0:
            diff = torch.linalg.vector_norm(w - w_cand, dim=1)
            bound = tol * torch.clamp(torch.linalg.vector_norm(w_cand, dim=1), min=1.0)
            hit = updated & (n_updates >= 1) & (diff < bound)
        else:
            hit = torch.zeros_like(converged)
        w = torch.where(converged[:, None], w, w_cand)
        n_updates = n_updates + (updated & ~converged).to(torch.int32)
        converged = converged | hit
        if tol > 0.0 and t % POLL_EVERY == 0 and t < total and bool(converged.all()):
            break
    return w, converged, n_updates


def pad_members(n_members: int, n_shards: int) -> int:
    """The smallest multiple of ``n_shards`` >= ``n_members``: the
    sharded engine's padded member count, shared with its record."""
    return -(-int(n_members) // int(n_shards)) * int(n_shards)


def train_linear_population_sharded(
    features: torch.Tensor,
    labels,
    config: sgd.SGDConfig,
    step_sizes: Sequence[float],
    reg_params: Sequence[float],
    seeds: Sequence[int],
    masks: Optional[np.ndarray],
    mesh,
    weight_pos: Optional[Sequence[float]] = None,
    weight_neg: Optional[Sequence[float]] = None,
    axis=None,
) -> torch.Tensor:
    """:func:`train_linear_population` with the member axis split over
    ``mesh``'s ``axis`` (None: its first axis; a tuple of names splits it
    over those axes, the first outermost): P members on N devices in
    blocks of ``pad_members(P, N) / N``. The argument contract is the
    batched engine's; a (P, n, d) ``features`` stack is split with the
    members. Padded members reuse member 0's hyperparameters and train
    under an all-zero sample mask, so they never update; real members get
    an explicit all-ones mask where ``masks`` is None, which the engine
    treats value for value as its implicit one. Each device's block runs
    the batched engine on that device; a failure raises. Returns (P, d)
    float32 weights in member order on the mesh's first device.

    Over a mesh of several processes the member axis must have the
    process axis (``hosts``) outermost: each process trains members
    ``[pid * per_host, (pid + 1) * per_host)`` of the padded ones
    (``per_host = padded // process_count``) on its own devices, and the
    (per_host, d) blocks are all-gathered in process order. The shared
    rows are the same on every process (the pod's features were
    exchanged), so nothing else crosses processes."""
    axes = (mesh.axis_names[0],) if axis is None else (
        (axis,) if isinstance(axis, str) else tuple(axis))
    multiproc = mesh.process_count > 1
    if multiproc and axes[0] != mesh.process_axis:
        raise ValueError(
            f"multi-process member sharding needs the "
            f"{mesh.process_axis!r} axis outermost, got {axes}"
        )
    local_axes = [a for a in axes if a != mesh.process_axis]
    if len(local_axes) == 1:
        devices = mesh.axis_devices(local_axes[0])
    else:  # every local axis (a pod's hosts x data), or none
        devices = mesh.local_devices if local_axes else [mesh.first_device]
    over_hosts = mesh.process_axis in axes
    n_shards = len(devices) * (mesh.process_count if over_hosts else 1)
    n_members = len(list(seeds))
    padded = pad_members(n_members, n_shards)
    pad = padded - n_members
    x = features.to(torch.float32)
    n = x.shape[-2]
    wp, wn, _weighted = _weight_arrays(config, n_members, weight_pos, weight_neg)

    def member_axis(values):
        values = list(values)
        return values + values[:1] * pad

    masks_arr = (np.ones((n_members, n), np.float32) if masks is None
                 else np.asarray(masks, np.float32))
    masks_arr = np.concatenate([masks_arr, np.zeros((pad, n), np.float32)])
    if x.dim() == 3 and pad:
        x = torch.cat([x, x[:1].expand(pad, -1, -1)])
    steps, regs, seeds_p = (member_axis(step_sizes), member_axis(reg_params),
                            member_axis(int(v) for v in seeds))
    wp, wn = member_axis(wp), member_axis(wn)
    per = padded // n_shards
    # this process's first member: its block of the padded members
    first = mesh.process_id * per * len(devices) if over_hosts else 0

    def shard(i, dev):
        block = slice(first + i * per, first + (i + 1) * per)
        xi = x[block] if x.dim() == 3 else x
        w, _, _ = train_linear_population(
            xi.to(dev), torch.as_tensor(labels).to(dev), config, steps[block], regs[block],
            seeds_p[block], masks_arr[block], weight_pos=wp[block], weight_neg=wn[block],
        )
        return w

    from . import mesh as pmesh

    weights = pmesh.gather(pmesh.run_on_shards(devices, shard), devices[0])
    if multiproc:
        from . import distributed

        weights = torch.cat(distributed.all_gather(weights))
    return weights[:n_members]


def train_linear_population_looped(
    features: torch.Tensor,
    labels,
    config: sgd.SGDConfig,
    step_sizes: Sequence[float],
    reg_params: Sequence[float],
    seeds: Sequence[int],
    masks: Optional[np.ndarray],
    weight_pos: Optional[Sequence[float]] = None,
    weight_neg: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """The sequential twin of :func:`train_linear_population`: each
    member's ``sgd.train_linear`` in turn, with its fold's mask when
    ``masks`` is given, on its own matrix ``features[i]`` when the
    features are (P, n, d). Returns (P, d) float32 weights."""
    import dataclasses

    p = len(list(seeds))
    wp, wn, _weighted = _weight_arrays(config, p, weight_pos, weight_neg)
    out = []
    for i in range(p):
        cfg = dataclasses.replace(
            config, step_size=float(step_sizes[i]), reg_param=float(reg_params[i]),
            seed=int(seeds[i]), weight_pos=wp[i], weight_neg=wn[i],
        )
        mask = None if masks is None else masks[i]
        x = features[i] if features.dim() == 3 else features
        out.append(sgd.train_linear(x, labels, cfg, sample_mask=mask))
    return torch.stack(out)


def train_nn_population(
    make_net: Callable[[int], torch.nn.Module],
    make_optimizer: Callable,
    loss_fn: Callable,
    features: torch.Tensor,
    onehot_labels: torch.Tensor,
    seeds: Sequence[int],
    learning_rates: Sequence[float],
    iterations: int,
) -> List[torch.nn.Module]:
    """Train P networks at once. ``make_net(seed)`` returns a network
    initialized from ``seed`` (on the features' device);
    ``make_optimizer(lrs, params)`` a first-order updater over the
    stacked parameters with the (P,) learning rates; ``loss_fn`` the
    configured loss. The members' parameters are stacked on a leading
    axis and run through the network's forward in one pass
    (``functional_call``: every product a batched one); the gradient of
    the sum of the members' losses is each member's own. Each iteration
    ``it`` draws member p's dropout masks from ``fold_in(prng_key(seeds[p]),
    it)``, as ``fit`` draws them. Returns the P networks, their parameters
    set to the members' results."""
    from torch.func import functional_call

    dev = features.device
    x, y = features, onehot_labels
    nets = [make_net(int(s)) for s in seeds]
    template = nets[0]
    names = [n for n, _ in template.named_parameters()]
    stacked = [torch.stack([net.get_parameter(n).detach() for net in nets]) for n in names]
    lrs = torch.tensor([float(np.float32(v)) for v in learning_rates], dtype=torch.float32,
                       device=dev)
    tx = make_optimizer(lrs, stacked)
    keys = threefry.prng_keys(torch.tensor([int(s) for s in seeds], dtype=torch.int64,
                                           device=dev))
    dropout = any(0.0 < d < 1.0 for d in template.dropouts)
    for it in range(int(iterations)):
        masks = (template.dropout_masks(threefry.fold_in(keys, it), tuple(x.shape), dev)
                 if dropout else [])
        with torch.enable_grad():
            params = [t.detach().requires_grad_(True) for t in stacked]
            pred = functional_call(template, dict(zip(names, params)), (x,),
                                   {"dropout_masks": masks})
            total = sum(loss_fn(pred[p], y) for p in range(len(nets)))
            grads = torch.autograd.grad(total, params)
        tx.update(stacked, grads)
    with torch.no_grad():
        for i, net in enumerate(nets):
            for n, t in zip(names, stacked):
                net.get_parameter(n).copy_(t[i])
    return nets
