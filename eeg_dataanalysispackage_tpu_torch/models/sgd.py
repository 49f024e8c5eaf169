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

Mini-batch sampling (``mini_batch_fraction < 1``) draws JAX's threefry
bits in the reference and is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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


def train_linear(
    features: torch.Tensor, labels: torch.Tensor, config: SGDConfig
) -> torch.Tensor:
    """Train a linear model on ``features``' device; returns (d,) float32
    weights there."""
    if config.mini_batch_fraction < 1.0:
        raise NotImplementedError(
            "mini_batch_fraction < 1 samples with the reference's threefry "
            "bits, not yet ported; see ROADMAP.md (threefry mini-batch "
            "sampling)"
        )
    if config.loss not in ("logistic", "hinge"):
        raise ValueError(f"unknown loss {config.loss!r}")
    x = features.to(torch.float32)
    y = labels.to(device=x.device, dtype=torch.float32)
    n, d = x.shape
    w = torch.zeros(d, dtype=torch.float32, device=x.device)
    if n == 0:
        return w  # an empty sample never updates
    class_w = (
        y * config.weight_pos + (1.0 - y) * config.weight_neg
        if config.weighted else None
    )
    f32 = np.float32
    # scalars in float32, as the JAX engine computes them
    scale = f32(1.0) / f32(n)
    tol = float(f32(config.convergence_tol))
    n_updates = 0
    for t in range(1, int(config.num_iterations) + 1):
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
        g = x.T @ mult
        step_t = f32(config.step_size) / np.sqrt(f32(t))
        decay = f32(1.0) - step_t * f32(config.reg_param)
        w_cand = w * float(decay) - float(step_t * scale) * g
        if n_updates >= 1:
            diff = torch.linalg.vector_norm(w - w_cand)
            bound = tol * torch.clamp(torch.linalg.vector_norm(w_cand), min=1.0)
            if bool(diff < bound):
                return w_cand
        w = w_cand
        n_updates += 1
    return w
