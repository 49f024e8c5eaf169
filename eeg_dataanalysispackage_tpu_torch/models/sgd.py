"""Full-batch SGD with Spark-MLlib-1.6 semantics, in PyTorch.

Port of the JAX package's ``models/sgd.py`` engine (MLlib's
``GradientDescent.runMiniBatchSGD`` behind ``LogisticRegressionWithSGD``
/ ``SVMWithSGD``). The same step, in float32 throughout:

- iteration t (1-based) uses step size ``step / sqrt(t)``;
- logistic gradient: mult = 1/(1+exp(-w.x)) - y, grad = mult * x;
- hinge gradient: y' = 2y-1, grad = -y'x when y'(w.x) < 1;
- SquaredL2Updater: w scaled by (1 - step_t*regParam) before the step;
- zero initial weights, no intercept;
- optional class weights scale each sample's gradient contribution;
  the average stays over the sample count;
- convergence: once an update has happened, stop when
  ``norm(w_prev - w_cur) < tol * max(norm(w_cur), 1)``. The JAX engine
  freezes the weights inside a fixed-length scan; breaking out of the
  loop gives the same weights.

:func:`train_linear` (the monolithic run) and :func:`partial_fit_linear`
(one chunk of iterations ``t_start+1 .. t_start+n`` from a carry, over a
fixed-capacity matrix with a sample mask: the serving lifecycle's
streaming partial fit) run the one step function, :func:`_step`, so a
chunked run replays the monolithic trajectory byte for byte.
:func:`train_linear_elastic` runs those chunks through
``obs.failure.elastic_train``: each chunk's carry is checkpointed in the
JAX package's layout (``w`` float32, ``converged`` bool, ``n_updates``
int32), and a failed chunk is replayed from the latest checkpoint.

Mini-batch sampling (``mini_batch_fraction < 1``): iteration ``t``
trains on the rows where ``uniform(fold_in(prng_key(seed), t), (n,)) <
fraction`` (``utils/threefry``: the JAX package's threefry draws, bit for
bit), times the sample mask where one is given, and averages over the
sampled count. The mask is drawn on the training device; the count and
the step's scalars stay there, so sampling adds no host round trip (the
convergence test, when ``convergence_tol > 0``, reads its one flag pair
a step, as the full-batch step does).

Data parallelism (``mesh=`` of :func:`train_linear` and
:func:`train_linear_elastic`): the batch is padded and split over the
mesh's data axis with a validity mask (``parallel/mesh.shard_batch_with_mask``),
each shard's gradient is computed on its device, the shard gradients are
added in shard order on the first device (the JAX package's psum, whose
order is XLA's), and the updated weights go back to every shard. As in
the JAX package, mini-batch draws span the padded rows. Over a mesh that
spans processes (a pod's hybrid mesh) each process holds its own shards of
the padded batch, every shard's gradient is all-gathered and every
process adds them in the same global shard order: a 2-process x 2-device
mesh gives the bits of one process's 4-shard mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..parallel import mesh as pmesh
from ..utils import threefry
from ..utils.device import resolve_device

_f32 = np.float32


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    num_iterations: int = 100
    step_size: float = 1.0
    mini_batch_fraction: float = 1.0
    reg_param: float = 0.0
    loss: str = "logistic"  # "logistic" | "hinge"
    seed: int = 42
    # MLlib GradientDescent default; 0.0 disables the early stop
    convergence_tol: float = 0.001
    weight_pos: float = 1.0
    weight_neg: float = 1.0

    @property
    def weighted(self) -> bool:
        return self.weight_pos != 1.0 or self.weight_neg != 1.0


#: ``(w, converged, n_updates)``: the (d,) float32 weights, whether the
#: early stop fired (the weights are frozen from then on), and the
#: updates made while not converged (a 0-d device tensor inside a
#: sampled run without the early stop, an int everywhere else)
Carry = Tuple[torch.Tensor, bool, int]


def _check_config(config: SGDConfig) -> None:
    if config.loss not in ("logistic", "hinge"):
        raise ValueError(f"unknown loss {config.loss!r}")


def mini_batch_mask(config: SGDConfig, t: int, n: int, device=None) -> torch.Tensor:
    """Iteration ``t``'s (1-based) Bernoulli(mini_batch_fraction) rows as
    a float32 0/1 vector of ``n`` on ``device``: the JAX engine's
    ``uniform(fold_in(PRNGKey(seed), t), (n,)) < fraction``."""
    key = threefry.fold_in(threefry.prng_key(config.seed), t)
    draw = threefry.uniform(key, (int(n),), device=device)
    return (draw < float(_f32(config.mini_batch_fraction))).to(torch.float32)


def mini_batch_masks(seeds: torch.Tensor, ts: torch.Tensor, n: int,
                     fraction: float) -> torch.Tensor:
    """:func:`mini_batch_mask` of every iteration in ``ts`` (T,) for every
    member seed in ``seeds`` (P,), in one pass: a (T, P, n) float32 0/1
    tensor on the seeds' device whose ``[i, p]`` row equals
    ``mini_batch_mask`` of seed ``p`` at iteration ``ts[i]`` bit for bit."""
    keys = threefry.fold_in(threefry.prng_keys(seeds.reshape(1, -1)), ts.reshape(-1, 1))
    draw = threefry.uniform(keys, (int(n),))
    return (draw < float(_f32(fraction))).to(torch.float32)


def _gradient(x, y, w, class_w, mask, config: SGDConfig) -> torch.Tensor:
    """``x.T @ (mult * class weight * mask)``, the loss's per-sample
    multiplier at ``w``. For a sharded ``x`` each shard's gradient is
    computed on its device and the shard gradients are added in shard
    order on ``w``'s device."""
    if isinstance(x, pmesh.ShardedArray):
        parts = [
            _gradient(xs, ys, w.to(xs.device), None if class_w is None else class_w.shards[i],
                      None if mask is None else mask.shards[i], config)
            for i, (xs, ys) in enumerate(zip(x.shards, y.shards))
        ]
        return pmesh.sum_in_order(parts, w.device, across_processes=x.across_processes)
    margin = x @ w
    if config.loss == "logistic":
        mult = torch.sigmoid(margin) - y
    else:
        y_signed = 2.0 * y - 1.0
        mult = torch.where(
            y_signed * margin < 1.0, -y_signed, torch.zeros((), device=x.device)
        )
    if class_w is not None:
        mult = mult * class_w
    if mask is not None:
        mult = mult * mask
    return x.T @ mult


def _step(x, y, class_w, mask, count: float, config: SGDConfig, carry: Carry,
          t: int) -> Carry:
    """Iteration ``t`` (1-based, absolute) of the MLlib-SGD loop over
    ``x`` (n, d), ``y`` (n,) and the optional sample ``mask`` (n,) whose
    sum is ``count`` (or, data-parallel, sharded ``x``, ``y``, class
    weights and mask); the JAX package's scan body (``_make_scan_step``).
    The gradient is ``x.T @ (mult * mask)`` averaged over ``count``; an
    empty sample neither decays nor updates. The scalars are float32, as
    the JAX engine computes them. With ``convergence_tol == 0`` the early
    stop cannot fire and the norms (a host sync each) are skipped.
    Under mini-batch sampling the iteration's draw multiplies the mask
    and the step runs in :func:`_sampled_step`."""
    if config.mini_batch_fraction < 1.0:
        return _sampled_step(x, y, class_w, mask, config, carry, t)
    w, converged, n_updates = carry
    g = _gradient(x, y, w, class_w, mask, config)
    updated = count > 0
    step_t = _f32(config.step_size) / np.sqrt(_f32(t))
    scale = _f32(1.0) / _f32(max(count, 1.0)) if updated else _f32(0.0)
    decay = _f32(1.0) - step_t * _f32(config.reg_param) if updated else _f32(1.0)
    w_cand = w * float(decay) - float(step_t * scale) * g
    hit = False
    tol = float(_f32(config.convergence_tol))
    if updated and n_updates >= 1 and tol > 0.0:
        diff = torch.linalg.vector_norm(w - w_cand)
        bound = tol * torch.clamp(torch.linalg.vector_norm(w_cand), min=1.0)
        hit = bool(diff < bound)
    if converged:
        return w, True, n_updates
    return w_cand, hit, n_updates + (1 if updated else 0)


def _sampled_step(x, y, class_w, mask, config: SGDConfig, carry: Carry,
                  t: int) -> Carry:
    """:func:`_step` with iteration ``t``'s sampled rows: the count, the
    ``1/max(count, 1)`` scale and the decay are float32 device scalars,
    selected on ``count > 0`` as the JAX scan selects them."""
    w, converged, n_updates = carry
    if converged:
        return w, True, n_updates
    draw = mini_batch_mask(config, t, x.shape[0], x.device)
    mask = draw if mask is None else mask * draw
    g = _gradient(x, y, w, class_w, mask, config)
    count = mask.sum()
    updated = count > 0
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    step_t = _f32(config.step_size) / np.sqrt(_f32(t))
    scale = torch.where(updated, 1.0 / torch.clamp(count, min=1.0), zero)
    decay = torch.where(updated, one * float(_f32(1.0) - step_t * _f32(config.reg_param)),
                        one)
    w_cand = w * decay - (scale * float(step_t)) * g
    tol = float(_f32(config.convergence_tol))
    if tol <= 0.0:
        # the early stop cannot fire: the update count stays on the device
        return w_cand, False, n_updates + updated.to(torch.int64)
    diff = torch.linalg.vector_norm(w - w_cand)
    bound = tol * torch.clamp(torch.linalg.vector_norm(w_cand), min=1.0)
    was_updated, below = torch.stack([updated, diff < bound]).tolist()
    hit = bool(was_updated and int(n_updates) >= 1 and below)
    return w_cand, hit, int(n_updates) + (1 if was_updated else 0)


def _prepare(features, labels, config: SGDConfig, sample_mask, device):
    """(x, y, class weights or None, mask or None, count) on ``device``;
    sharded inputs (the data-parallel form) stay on their shards."""
    if isinstance(features, pmesh.ShardedArray):
        class_w = (labels.map(lambda y: y * config.weight_pos + (1.0 - y) * config.weight_neg)
                   if config.weighted else None)
        return features, labels, class_w, sample_mask, float(sample_mask.sum().item())
    x = torch.as_tensor(features, device=device).to(torch.float32)
    y = torch.as_tensor(labels, device=device).to(torch.float32)
    class_w = (
        y * config.weight_pos + (1.0 - y) * config.weight_neg
        if config.weighted else None
    )
    if sample_mask is None:
        return x, y, class_w, None, float(x.shape[0])
    mask = torch.as_tensor(sample_mask, device=device).to(torch.float32)
    return x, y, class_w, mask, float(mask.sum().item())


def _shard(mesh, features, labels, sample_mask):
    """The data-parallel inputs: ``features``, ``labels`` and the validity
    mask (times ``sample_mask``, padded with zeros, when given) split
    over ``mesh``'s data axis."""
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    x, y, mask = pmesh.shard_batch_with_mask(mesh, host(features), host(labels))
    if sample_mask is not None:
        mask = mask * pmesh.shard_batch(np.asarray(host(sample_mask), np.float32), mesh)[0]
    return x, y, mask


def train_linear(
    features: torch.Tensor, labels: torch.Tensor, config: SGDConfig,
    sample_mask=None, mesh=None,
) -> torch.Tensor:
    """Train a linear model on ``features``' device; returns (d,) float32
    weights there. ``sample_mask`` (n,) selects the training rows of the
    full matrix (a multi-fold population member's fold), as the JAX
    engine's ``sample_mask`` does: mini-batch draws still span all n.
    With ``mesh`` the batch is split over its data axis (data-parallel;
    the module's docstring) and the weights land on its first device."""
    _check_config(config)
    if mesh is not None:
        features, labels, sample_mask = _shard(mesh, features, labels, sample_mask)
    x, y, class_w, mask, count = _prepare(features, labels, config, sample_mask,
                                          features.device)
    carry: Carry = partial_fit_carry(x.shape[1], device=x.device)
    if x.shape[0] == 0:
        return carry[0]  # an empty sample never updates
    for t in range(1, int(config.num_iterations) + 1):
        carry = _step(x, y, class_w, mask, count, config, carry, t)
        if carry[1]:
            break  # the JAX scan's frozen carry
    return carry[0]


def partial_fit_carry(
    n_features: int,
    weights=None,
    device: Optional[Union[str, torch.device]] = None,
) -> Carry:
    """A fresh ``(w, converged, n_updates)`` carry on ``device``: zero
    weights, or a warm start from a float32 weight vector (the serving
    lifecycle stages its candidate from the live model's weights)."""
    dev = resolve_device(device)
    if weights is None:
        w = torch.zeros(int(n_features), dtype=torch.float32, device=dev)
    else:
        w = torch.as_tensor(np.asarray(weights, np.float32), device=dev).clone()
    return w, False, 0


def partial_fit_linear(
    carry,
    t_start: int,
    features,
    labels,
    config: SGDConfig,
    n_iterations: int,
    sample_mask=None,
    device: Optional[Union[str, torch.device]] = None,
) -> Carry:
    """One streaming partial-fit chunk on ``device``: iterations
    ``t_start+1 .. t_start+n_iterations`` of the MLlib-SGD loop over the
    current (fixed-capacity) feedback matrix, from ``carry``.

    Absolute iteration indices keep the step sizes on the one trajectory,
    so a run that restores a checkpointed carry and replays the remaining
    chunks gives the same weights; ``sample_mask`` marks the live rows.
    ``features``, ``labels`` and ``sample_mask`` may be numpy arrays or
    tensors (copied to ``device`` once). Returns the new carry."""
    _check_config(config)
    dev = resolve_device(device)
    x, y, class_w, mask, count = _prepare(features, labels, config, sample_mask, dev)
    w, converged, n_updates = carry
    out: Carry = (
        torch.as_tensor(w, device=dev).to(torch.float32), bool(converged),
        int(n_updates),
    )
    for t in range(int(t_start) + 1, int(t_start) + int(n_iterations) + 1):
        out = _step(x, y, class_w, mask, count, config, out, t)
    return out[0], out[1], int(out[2])


def train_linear_elastic(
    features: torch.Tensor,
    labels,
    config: SGDConfig,
    manager,
    chunk_iters: int = 10,
    save_every: int = 1,
    max_restarts: int = 3,
    sentinel=None,
    probe_on_failure: bool = True,
    mesh=None,
) -> torch.Tensor:
    """:func:`train_linear` with mid-train checkpoint/restore: the
    iterations run in ``chunk_iters`` chunks (:func:`partial_fit_linear`,
    absolute indices) through ``obs.failure.elastic_train``; every
    chunk's carry is checkpointed under ``manager`` as ``{"w",
    "converged", "n_updates"}`` (float32, bool, int32: the JAX package's
    layout, so either package restores the other's). A failed chunk
    restores the latest carry and replays only what was not saved, on
    the one trajectory, so the weights equal :func:`train_linear`'s.
    Each chunk fires the ``device.step`` chaos point; the weight norm is
    the divergence sentinel's loss stream. Returns (d,) float32 weights
    on ``features``' device (``mesh``: data-parallel over its data axis,
    the weights on its first device)."""
    from ..obs import chaos, events, failure

    _check_config(config)
    sample_mask = None
    if mesh is not None:
        x, y, sample_mask = _shard(mesh, features, labels, None)
    else:
        x = features.to(torch.float32)
        y = torch.as_tensor(labels, device=features.device).to(torch.float32)
    dev = x.device
    total = int(config.num_iterations)
    chunks = [(t0, min(int(chunk_iters), total - t0))
              for t0 in range(0, total, int(chunk_iters))]

    def init_state():
        return {"w": torch.zeros(x.shape[1], dtype=torch.float32, device=dev),
                "converged": np.bool_(False), "n_updates": np.int32(0)}

    def chunk_step(state, t0, n):
        events.event("train.sgd_chunk", t0=int(t0), iters=int(n))
        chaos.maybe_fire("device.step")
        w = torch.as_tensor(state["w"], device=dev).to(torch.float32)
        out = partial_fit_linear((w, bool(state["converged"]), int(state["n_updates"])),
                                 t0, x, y, config, n, sample_mask=sample_mask, device=dev)
        new = {"w": out[0], "converged": np.bool_(out[1]), "n_updates": np.int32(out[2])}
        return new, torch.linalg.vector_norm(out[0])

    state, _, _ = failure.elastic_train(
        manager, init_state, chunk_step, lambda: list(chunks),
        max_restarts=max_restarts, save_every=save_every, sentinel=sentinel,
        probe_on_failure=probe_on_failure,
    )
    return torch.as_tensor(state["w"], device=dev).to(torch.float32)


def predict_margin(features: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The linear margin ``features @ weights``."""
    return features @ weights
