"""Neural-network classifier: a torch module with flax's layout, optax's rules.

Port of the JAX package's ``models/nn.py`` (the reference's DL4J
``NeuralNetworkClassifier``). The ``config_*`` surface, its required
keys, silent enum fallbacks and messages are the JAX package's:

- required scalars ``config_seed``, ``config_num_iterations``,
  ``config_learning_rate``, ``config_momentum``, ``config_weight_init``,
  ``config_updater``, ``config_optimization_algo``, ``config_pretrain``,
  ``config_backprop``; layers from ``config_layer{i}_layer_type``
  (output|dense|auto_encoder|rbm|graves_lstm), ``_n_out``, ``_drop_out``,
  ``_activation_function``; ``config_loss_function`` (default mse) and
  the optional class weights ``config_weight_pos``/``config_weight_neg``;
- labels are the one-hot pairs ``[target, 1 - target]`` and the
  prediction is ``output[:, 0]``;
- ``graves_lstm`` is flax's ``OptimizedLSTMCell`` (gates i, f, g, o; input
  kernels ``ii..io`` without bias, recurrent ``hi..ho`` with bias, sigmoid
  gates, the layer's activation as the cell's), one step on flat input,
  scanned over ``(batch, time, features)`` sequences; the output layer
  reads the last step.

Every random draw follows the JAX package's threefry streams
(``utils/threefry``): ``model.init``'s weights by their flax path
(``fold_in_static(PRNGKey(seed), "layer{i}"[, gate], 1)``), the dropout
masks (``fold_in(PRNGKey(seed), it)`` then ``Dropout_{j}``), the
denoising masks (``fold_in(fold_in(rng, 1000 + i), it)``) and the CD-1
samples. Dense initial weights are bit-equal to flax's; ``he_normal``
and the LSTM's orthogonal recurrent kernels go through the float32
``erf_inv`` map (a few ulp) and a QR.

The update rules are optax 0.2.6's, written out in torch (``sgd``;
``nesterovs`` = ``sgd(momentum, nesterov=True)``; ``adam`` with eps 1e-8
and bias correction; ``adagrad`` from an accumulator of 0.1 with eps
1e-7; ``rmsprop`` with decay 0.9 and eps 1e-8 inside the root;
Polak-Ribière+ conjugate gradient at the configured step). Training runs
``config_num_iterations`` full-batch steps on the device of the
features; every per-step scalar is computed on the host or stays on the
device, so the loop makes no host round trip.

A model file is ``len(header)`` (8 bytes, little-endian), the JSON
header ``{"arch", "config"}``, then flax's msgpack of the parameter tree
(``checkpoint/codec.py``), byte-identical to the JAX package's for the
same parameters: the tree's key order is the JAX package's (flax's
creation order after ``init`` or ``load``, sorted after a trained fit).
:func:`params_from_jax` and :func:`params_to_jax` carry flax's nested
numpy trees across.

Not ported (they raise "not yet ported; see ROADMAP.md"): the
``lbfgs`` and ``line_gradient_descent`` algorithms (optax's line
searches), ``population_fit`` and ``fit_elastic``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from . import base
from ..checkpoint import codec
from ..io import modelfiles
from ..utils import threefry

_ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "relu": torch.relu,
    "tanh": torch.tanh,
    "identity": lambda x: x,
    "softplus": nn.functional.softplus,
    "elu": nn.functional.elu,
}
_LAYER_TYPES = ("output", "dense", "auto_encoder", "rbm", "graves_lstm")
_PRETRAINABLE = ("auto_encoder", "rbm")
# DL4J 0.8 AutoEncoder default corruption level (denoising)
_AE_CORRUPTION = 0.3
_WEIGHT_INITS = ("xavier", "zero", "sigmoid", "uniform", "relu")
_UPDATERS = ("sgd", "adam", "nesterovs", "adagrad", "rmsprop")
_GATES = ("i", "f", "g", "o")
_MLLIB_REFUSAL = (
    "config_model_format=mllib is not available for nn: DL4J ModelSerializer "
    "zips wrap closed ND4J serialization (docs/MIGRATION.md)"
)
_f32 = np.float32
#: rows per block of :meth:`NeuralNetworkClassifier.output` (the serving
#: engine's capacity multiple)
PREDICT_ROWS = 64


def _activation(name: str):
    return _ACTIVATIONS.get(name, _ACTIVATIONS["sigmoid"])


# -- initializers (flax linen.initializers as the JAX package maps them) ---


def _init_kernel(name: str, key, shape, device) -> torch.Tensor:
    """``_weight_init(name)(key, shape)``: xavier and sigmoid are
    glorot_uniform, uniform is uniform(0.01), zero is zeros, and every
    other name he_normal (truncated normal over .87962566103423978)."""
    name = name if name in _WEIGHT_INITS else "relu"
    fan_in, fan_out = shape[-2], shape[-1]
    if name in ("xavier", "sigmoid"):
        variance = _f32(1.0 / ((fan_in + fan_out) / 2))
        scale = float(np.sqrt(_f32(3) * variance))
        return threefry.uniform(key, shape, -1.0, 1.0, device) * scale
    if name == "zero":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if name == "uniform":
        return threefry.uniform(key, shape, device=device) * float(_f32(0.01))
    variance = _f32(2.0 / fan_in)
    stddev = float(np.sqrt(variance) / _f32(0.87962566103423978))
    return threefry.truncated_normal(key, -2.0, 2.0, shape, device) * stddev


def _orthogonal(key, n: int, device) -> torch.Tensor:
    """flax's ``orthogonal()`` of an (n, n) kernel: a normal draw, its
    QR, the columns signed by R's diagonal."""
    z = threefry.normal(key, (n, n), device)
    q, r = torch.linalg.qr(z)
    return q * torch.sign(torch.diagonal(r)).unsqueeze(-2)


# -- the network -----------------------------------------------------------


class _Dense(nn.Module):
    """flax ``Dense``: ``x @ kernel + bias``, kernel (in, out)."""

    def __init__(self, n_in: int, n_out: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(n_in, n_out))
        self.bias = nn.Parameter(torch.zeros(n_out)) if use_bias else None

    def forward(self, x):
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class _LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: input kernels ``ii, if, ig, io`` (no
    bias) and recurrent ``hi, hf, hg, ho`` (with bias), each gate's
    kernels concatenated into one product per step."""

    def __init__(self, n_in: int, n_out: int, activation: str):
        super().__init__()
        self.n_out = n_out
        self.act = _activation(activation)
        for g in _GATES:
            self.add_module(f"i{g}", _Dense(n_in, n_out, use_bias=False))
            self.add_module(f"h{g}", _Dense(n_out, n_out))

    def forward(self, seq):
        """(batch, time, features) -> (batch, time, n_out), from a zero
        carry."""
        ki = torch.cat([getattr(self, f"i{g}").kernel for g in _GATES], dim=-1)
        kh = torch.cat([getattr(self, f"h{g}").kernel for g in _GATES], dim=-1)
        bh = torch.cat([getattr(self, f"h{g}").bias for g in _GATES], dim=-1)
        batch = seq.shape[0]
        c = seq.new_zeros((batch, self.n_out))
        h = seq.new_zeros((batch, self.n_out))
        out = []
        for t in range(seq.shape[1]):
            dh = torch.split(h @ kh + bh, self.n_out, dim=-1)
            di = torch.split(seq[:, t] @ ki, self.n_out, dim=-1)
            i = torch.sigmoid(dh[0] + di[0])
            f = torch.sigmoid(dh[1] + di[1])
            g = self.act(dh[2] + di[2])
            o = torch.sigmoid(dh[3] + di[3])
            c = f * c + i * g
            h = o * self.act(c)
            out.append(h)
        return torch.stack(out, dim=1)


class _Net(nn.Module):
    """The configured layer stack, one module per layer named
    ``layer{i}`` (a :class:`_Dense`, or an :class:`_LSTMCell` for
    ``graves_lstm``), flax's parameter layout: ``layer{i}.kernel``,
    ``layer{i}.bias``, ``layer{i}.hf.kernel``, ...

    ``layout`` is the parameter tree's key order as the JAX package
    holds it (see :func:`params_to_jax`)."""

    def __init__(self, layer_types: Sequence[str], n_outs: Sequence[int],
                 activations: Sequence[str], dropouts: Sequence[float], n_in: int):
        super().__init__()
        self.layer_types = tuple(layer_types)
        self.n_outs = tuple(int(n) for n in n_outs)
        self.activations = tuple(activations)
        self.dropouts = tuple(float(d) for d in dropouts)
        width = int(n_in)
        for i, (ltype, n_out, act) in enumerate(
                zip(self.layer_types, self.n_outs, self.activations)):
            if ltype == "graves_lstm":
                layer = _LSTMCell(width, n_out, act)
            else:
                layer = _Dense(width, n_out)
            self.add_module(f"layer{i + 1}", layer)
            width = n_out
        self.layout = creation_layout(self.layer_types)

    def layer(self, i: int) -> nn.Module:
        return getattr(self, f"layer{i + 1}")

    def forward(self, x, dropout_key: Optional[threefry.Key] = None,
                n_layers: Optional[int] = None):
        """The forward pass; with ``dropout_key`` (training) each layer
        with a dropout rate masks its output with the key flax derives for
        its ``Dropout_{j}`` module. ``n_layers`` runs a prefix without
        dropout."""
        last = len(self.n_outs) if n_layers is None else n_layers
        j = 0
        for i in range(last):
            ltype, act, drop = self.layer_types[i], self.activations[i], self.dropouts[i]
            if ltype == "graves_lstm":
                seq = x if x.ndim == 3 else x[:, None, :]
                seq = self.layer(i)(seq)
                x = seq if x.ndim == 3 else seq[:, -1, :]
            else:
                if i == len(self.n_outs) - 1 and x.ndim == 3:
                    x = x[:, -1, :]
                x = _activation(act)(self.layer(i)(x))
            if drop > 0.0 and n_layers is None:
                if dropout_key is not None and drop < 1.0:
                    keep = 1.0 - drop
                    key = threefry.fold_in_static(dropout_key, f"Dropout_{j}", 1)
                    mask = threefry.bernoulli(key, keep, tuple(x.shape), x.device)
                    x = torch.where(mask, x / keep, torch.zeros_like(x))
                elif dropout_key is not None:
                    x = torch.zeros_like(x)
                j += 1
        return x


def creation_layout(layer_types: Sequence[str]) -> Dict:
    """The key order of flax's ``model.init`` tree (and of one restored
    into it): layers in order, ``kernel`` before ``bias``; an LSTM's
    gates sorted, ``bias`` before ``kernel``."""
    layers = {}
    for i, ltype in enumerate(layer_types):
        if ltype == "graves_lstm":
            layers[f"layer{i + 1}"] = {
                g: ({"bias": None, "kernel": None} if g[0] == "h" else {"kernel": None})
                for g in sorted(f"{p}{c}" for p in "hi" for c in _GATES)
            }
        else:
            layers[f"layer{i + 1}"] = {"kernel": None, "bias": None}
    return {"params": layers}


def _sorted_layout(layout: Dict) -> Dict:
    """The same tree with every dict's keys sorted (a tree that went
    through ``jax.tree_util``)."""
    return {k: (_sorted_layout(v) if isinstance(v, dict) else None)
            for k, v in sorted(layout.items())}


def _leaf_paths(layout: Dict, prefix=()) -> List[tuple]:
    out = []
    for k, v in layout.items():
        out += _leaf_paths(v, prefix + (k,)) if isinstance(v, dict) else [prefix + (k,)]
    return out


def _parameter(net: _Net, path: tuple) -> nn.Parameter:
    """The module parameter at a flax path ``("params", "layer1", ...)``."""
    return net.get_parameter(".".join(path[1:]))


def params_to_jax(net: _Net) -> Dict:
    """flax's nested numpy parameter tree of ``net``, keys in its
    ``layout`` order."""

    def walk(layout, prefix):
        return {
            k: (walk(v, prefix + (k,)) if isinstance(v, dict)
                else _parameter(net, prefix + (k,)).detach().cpu().numpy().copy())
            for k, v in layout.items()
        }

    return walk(net.layout, ())


def params_from_jax(tree: Dict, net: _Net) -> _Net:
    """Copy flax's nested numpy tree ``{"params": {...}}`` into ``net``
    (in place, on its device) and adopt the tree's key order; the keys
    must be ``net``'s."""
    want = sorted(_leaf_paths(creation_layout(net.layer_types)))
    got = sorted(_leaf_paths(tree))
    if want != got:
        raise ValueError(
            "The target dict keys and state dict keys do not match, target "
            f"dict contains keys {want} and the state dict {got}"
        )
    with torch.no_grad():
        for path in got:
            node = tree
            for k in path:
                node = node[k]
            param = _parameter(net, path)
            arr = np.array(node, dtype=np.float32)
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, expected "
                                 f"{tuple(param.shape)}")
            param.copy_(torch.from_numpy(arr))

    def skeleton(node):
        return {k: (skeleton(v) if isinstance(v, dict) else None) for k, v in node.items()}

    net.layout = skeleton(tree)
    return net


def _init_params(net: _Net, seed: int, weight_init: str, device) -> None:
    """``model.init({"params": PRNGKey(seed)})``'s draws, by flax path."""
    rng = threefry.prng_key(seed)
    with torch.no_grad():
        for i, ltype in enumerate(net.layer_types):
            name = f"layer{i + 1}"
            layer = net.layer(i)
            if ltype != "graves_lstm":
                key = threefry.fold_in_static(rng, name, 1)
                layer.kernel.copy_(_init_kernel(weight_init, key, tuple(layer.kernel.shape),
                                                device))
                layer.bias.zero_()
                continue
            for g in _GATES:
                ki = getattr(layer, f"i{g}").kernel
                key = threefry.fold_in_static(rng, name, f"i{g}", 1)
                ki.copy_(_init_kernel(weight_init, key, tuple(ki.shape), device))
                kh = getattr(layer, f"h{g}")
                key = threefry.fold_in_static(rng, name, f"h{g}", 1)
                kh.kernel.copy_(_orthogonal(key, kh.kernel.shape[0], device))
                kh.bias.zero_()


# -- losses ------------------------------------------------------------------


def _loss_fn(name: str, weight_pos: float = 1.0, weight_neg: float = 1.0):
    """The configured loss (mse, xent, squared_loss, negativeloglikelihood;
    mse otherwise) with the JAX package's clips; with non-unit class
    weights each sample's term scales by its class's weight, normalized
    by the weight sum."""
    lo, hi = 1e-7, 1 - 1e-7

    def mse(pred, y):
        return torch.mean((pred - y) ** 2)

    def xent(pred, y):
        p = torch.clamp(pred, lo, hi)
        return -torch.mean(y * torch.log(p) + (1 - y) * torch.log1p(-p))

    def nll(pred, y):
        p = torch.clamp(pred, lo, 1.0)
        return -torch.mean(torch.sum(y * torch.log(p), dim=-1))

    losses = {"mse": mse, "xent": xent, "squared_loss": mse,
              "negativeloglikelihood": nll}
    if weight_pos == 1.0 and weight_neg == 1.0:
        return losses.get(name, mse)

    def per_sample(pred, y):
        if name == "xent":
            p = torch.clamp(pred, lo, hi)
            return -torch.mean(y * torch.log(p) + (1 - y) * torch.log1p(-p), dim=-1)
        if name == "negativeloglikelihood":
            p = torch.clamp(pred, lo, 1.0)
            return -torch.sum(y * torch.log(p), dim=-1)
        return torch.mean((pred - y) ** 2, dim=-1)

    def weighted(pred, y):
        t = y[..., 0]
        w = t * weight_pos + (1.0 - t) * weight_neg
        return torch.sum(w * per_sample(pred, y)) / torch.sum(w)

    return weighted


# -- optax's update rules ------------------------------------------------------


class _Optimizer:
    """One optax transformation over a list of float32 tensors (the
    parameters in the JAX tree's leaf order). :meth:`update` takes the
    gradients and applies the step in place (``optax.apply_updates``)."""

    def __init__(self, kind: str, lr: float, momentum: float, params):
        self.kind = kind
        self.neg_lr = float(_f32(-lr))
        self.lr = float(_f32(lr))
        self.momentum = float(_f32(momentum))
        self.count = 0
        zeros = [torch.zeros_like(p) for p in params]
        if kind == "adam":
            self.mu, self.nu = zeros, [torch.zeros_like(p) for p in params]
        elif kind == "adagrad":
            self.sos = [torch.full_like(p, float(_f32(0.1))) for p in params]
        elif kind == "rmsprop":
            self.nu = zeros
        elif kind == "nesterovs":
            self.trace = zeros
        elif kind == "conjugate_gradient":
            self.prev_g, self.prev_d = zeros, [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def update(self, params, grads) -> None:
        getattr(self, "_" + self.kind)(params, grads)

    def _sgd(self, params, grads):
        for p, g in zip(params, grads):
            p.add_(self.neg_lr * g)

    def _nesterovs(self, params, grads):
        m = self.momentum
        for k, (p, g) in enumerate(zip(params, grads)):
            t = g + m * self.trace[k]
            self.trace[k] = t
            p.add_(self.neg_lr * (g + m * t))

    def _adam(self, params, grads):
        b1, b2, eps = 0.9, 0.999, float(_f32(1e-8))
        self.count += 1
        bc1 = float(_f32(1.0) - np.power(_f32(b1), _f32(self.count)))
        bc2 = float(_f32(1.0) - np.power(_f32(b2), _f32(self.count)))
        c1, c2 = float(_f32(1 - b1)), float(_f32(1 - b2))
        for k, (p, g) in enumerate(zip(params, grads)):
            self.mu[k] = c1 * g + float(_f32(b1)) * self.mu[k]
            self.nu[k] = c2 * (g * g) + float(_f32(b2)) * self.nu[k]
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + eps)
            p.add_(self.neg_lr * u)

    def _adagrad(self, params, grads):
        eps = float(_f32(1e-7))
        for k, (p, g) in enumerate(zip(params, grads)):
            sos = g * g + self.sos[k]
            self.sos[k] = sos
            inv = torch.where(sos > 0, torch.rsqrt(sos + eps), torch.zeros_like(sos))
            p.add_(self.neg_lr * (inv * g))

    def _rmsprop(self, params, grads):
        decay, eps = 0.9, float(_f32(1e-8))
        c = float(_f32(1 - decay))
        for k, (p, g) in enumerate(zip(params, grads)):
            nu = c * (g * g) + float(_f32(decay)) * self.nu[k]
            self.nu[k] = nu
            p.add_(self.neg_lr * (torch.rsqrt(nu + eps) * g))

    def _conjugate_gradient(self, params, grads):
        """Polak-Ribière+: beta = max(g.(g - g_prev) / |g_prev|^2, 0),
        0 on the first step; d = -g + beta d_prev; the step lr * d."""
        num = sum(torch.sum(g * (g - pg)) for g, pg in zip(grads, self.prev_g))
        den = sum(torch.sum(pg * pg) for pg in self.prev_g)
        zero = torch.zeros((), dtype=torch.float32, device=den.device)
        beta = torch.where(den > 0.0,
                           torch.clamp(num / torch.clamp(den, min=1e-30), min=0.0), zero)
        dirs = [-g + beta * pd for g, pd in zip(grads, self.prev_d)]
        for p, d in zip(params, dirs):
            p.add_(self.lr * d)
        self.prev_g, self.prev_d = list(grads), dirs


def _not_ported_algo(algo: str) -> None:
    if algo in ("lbfgs", "line_gradient_descent"):
        raise NotImplementedError(
            f"config_optimization_algo={algo} (optax's line-search "
            "transforms) is not yet ported; see ROADMAP.md"
        )


def _optimizer(algo: str, updater_name: str, lr: float, momentum: float, params):
    """``config_optimization_algo``'s transform: conjugate_gradient runs
    PR+ CG, every other value the configured updater (unknown names fall
    back to nesterovs); lbfgs and line_gradient_descent raise."""
    _not_ported_algo(algo)
    if algo == "conjugate_gradient":
        return _Optimizer("conjugate_gradient", lr, momentum, params)
    return _updater(updater_name, lr, momentum, params)


def _updater(name: str, lr: float, momentum: float, params):
    return _Optimizer(name if name in _UPDATERS else "nesterovs", lr, momentum, params)


# -- greedy layerwise pretraining ------------------------------------------------


def _pretrain_ae(key, h, kernel, bias, act_name, make_tx, iterations):
    """Tied-weight denoising autoencoder on activations ``h``: encode
    ``act((h * keep) @ W + b)``, decode ``z @ W.T + c``, minimize the MSE
    to ``h``; keep ~ Bernoulli(0.7) from ``fold_in(key, it)``. Returns
    the trained (W, b)."""
    act = _activation(act_name)
    # the JAX tree {"W", "b", "c"} in its sorted leaf order
    params = [kernel.detach().clone().requires_grad_(True),
              bias.detach().clone().requires_grad_(True),
              torch.zeros(h.shape[1], dtype=h.dtype, device=h.device, requires_grad=True)]
    tx = make_tx(params)
    for it in range(int(iterations)):
        keep = threefry.bernoulli(threefry.fold_in(key, it), 1.0 - _AE_CORRUPTION,
                                  tuple(h.shape), h.device).to(h.dtype)
        W, b, c = params
        z = act((h * keep) @ W + b)
        r = z @ W.T + c
        loss = torch.mean((r - h) ** 2)
        grads = torch.autograd.grad(loss, params)
        tx.update(params, grads)
    return params[0].detach(), params[1].detach()


@torch.no_grad()
def _pretrain_rbm(key, h, kernel, bias, make_tx, iterations):
    """CD-1 contrastive divergence: sigmoid hidden units sampled from
    ``fold_in(key, it)``, linear visible reconstruction. Returns the
    trained (W, b)."""
    params = [kernel.detach().clone(), bias.detach().clone(),
              torch.zeros(h.shape[1], dtype=h.dtype, device=h.device)]
    tx = make_tx(params)
    n = float(h.shape[0])
    v0 = h
    for it in range(int(iterations)):
        W, b, c = params
        h0_prob = torch.sigmoid(v0 @ W + b)
        h0_sample = threefry.bernoulli(threefry.fold_in(key, it), h0_prob).to(v0.dtype)
        v1 = h0_sample @ W.T + c
        h1_prob = torch.sigmoid(v1 @ W + b)
        g_w = -(v0.T @ h0_prob - v1.T @ h1_prob) / n
        g_b = -torch.mean(h0_prob - h1_prob, dim=0)
        g_c = -torch.mean(v0 - v1, dim=0)
        tx.update(params, [g_w, g_b, g_c])
    return params[0], params[1]


# -- the classifier ------------------------------------------------------------


class NeuralNetworkClassifier(base.Classifier):
    confusion_only_stats = False  # the reference NN builds stats with add()

    def __init__(self) -> None:
        super().__init__()
        self.net: Optional[_Net] = None
        self._arch: Optional[Dict] = None

    def set_config(self, config) -> None:
        # refused at config time, before a training run the save would waste
        if dict(config).get("config_model_format") == "mllib":
            raise NotImplementedError(_MLLIB_REFUSAL)
        super().set_config(config)

    # -- config parsing --------------------------------------------------

    def _parse_layers(self) -> tuple:
        c = self.config
        num_layers = sum(1 for k in c if k.startswith("config_layer")) // 4
        if num_layers == 0:
            raise ValueError("no config_layer* keys; at least one layer required")
        ltypes: List[str] = []
        n_outs: List[int] = []
        acts: List[str] = []
        drops: List[float] = []
        for i in range(1, num_layers + 1):
            ltype = c.get(f"config_layer{i}_layer_type", "output")
            if ltype not in _LAYER_TYPES:
                ltype = "output"
            ltypes.append(ltype)
            n_outs.append(int(c[f"config_layer{i}_n_out"]))
            acts.append(c[f"config_layer{i}_activation_function"])
            drops.append(float(c[f"config_layer{i}_drop_out"]))
        return ltypes, n_outs, acts, drops

    def _require(self, key: str) -> str:
        if key not in self.config:
            raise ValueError(f"missing required NN config key: {key}")
        return self.config[key]

    def _parse_scalars(self) -> dict:
        return {
            "seed": int(self._require("config_seed")),
            "iterations": int(self._require("config_num_iterations")),
            "lr": float(self._require("config_learning_rate")),
            "momentum": float(self._require("config_momentum")),
            "weight_init": self._require("config_weight_init"),
            "updater_name": self._require("config_updater"),
            "algo": self._require("config_optimization_algo").lower(),
            # Boolean.parseBoolean: "true" in any case
            "pretrain": self._require("config_pretrain").lower() == "true",
            "backprop": self._require("config_backprop").lower() == "true",
            "weight_pos": float(self.config.get("config_weight_pos", 1.0)),
            "weight_neg": float(self.config.get("config_weight_neg", 1.0)),
        }

    def _build(self, device=None) -> _Net:
        a = self._arch
        return _Net(a["layer_types"], a["n_outs"], a["activations"], a["dropouts"],
                    a["n_in"]).to(device if device is not None else "cpu")

    # -- training ----------------------------------------------------------

    def fit(self, features: torch.Tensor, labels: torch.Tensor) -> None:
        self._fit(features, labels)

    def _fit(self, features, labels, init: Optional[Dict] = None) -> None:
        """:meth:`fit`; ``init`` (flax's numpy tree) replaces the initial
        draw, so a run can start from another package's ``model.init``."""
        c = self._parse_scalars()
        ltypes, n_outs, acts, drops = self._parse_layers()
        device = features.device
        x = features.to(torch.float32)
        t = torch.as_tensor(labels, device=device).to(torch.float32)
        y = torch.stack([t, torch.abs(1.0 - t)], dim=1)
        self._arch = {
            "layer_types": ltypes,
            "n_outs": n_outs,
            "activations": acts,
            "dropouts": drops,
            "weight_init": c["weight_init"],
            "n_in": int(x.shape[-1]),
        }
        net = self._build(device)
        if init is None:
            _init_params(net, c["seed"], c["weight_init"], device)
        else:
            params_from_jax(init, net)
        rng = threefry.prng_key(c["seed"])
        _not_ported_algo(c["algo"])
        loss = _loss_fn(self.config.get("config_loss_function", "mse"),
                        weight_pos=c["weight_pos"], weight_neg=c["weight_neg"])
        if c["pretrain"]:
            self._greedy_pretrain(net, x, c, rng)
        if c["backprop"]:
            paths = _leaf_paths(_sorted_layout(net.layout))
            params = [_parameter(net, p) for p in paths]
            tx = _optimizer(c["algo"], c["updater_name"], c["lr"], c["momentum"], params)
            for it in range(c["iterations"]):
                pred = net(x, dropout_key=threefry.fold_in(rng, it))
                grads = torch.autograd.grad(loss(pred, y), params)
                tx.update(params, grads)
        if c["pretrain"] or c["backprop"]:
            # the JAX package's tree went through jax.tree_util
            net.layout = _sorted_layout(net.layout)
        for p in net.parameters():
            p.requires_grad_(False)
        self.net = net

    def _greedy_pretrain(self, net: _Net, x, c: dict, rng) -> None:
        """DL4J's pretrain walk: each auto_encoder/rbm layer but the last
        trains unsupervised on the activations of the layers before it
        (current weights, no dropout); its kernel and bias are written
        back. AE layers honour the configured algorithm, RBM layers use
        the first-order updater."""
        ltypes = net.layer_types
        for i, ltype in enumerate(ltypes):
            if ltype not in _PRETRAINABLE or i == len(ltypes) - 1:
                continue
            with torch.no_grad():
                h = x if i == 0 else net(x, n_layers=i)
            if h.ndim == 3:
                h = h.reshape(-1, h.shape[-1])
            layer = net.layer(i)
            key = threefry.fold_in(rng, 1000 + i)
            if ltype == "auto_encoder":
                w, b = _pretrain_ae(
                    key, h, layer.kernel, layer.bias, net.activations[i],
                    lambda p: _optimizer(c["algo"], c["updater_name"], c["lr"],
                                         c["momentum"], p),
                    c["iterations"],
                )
            else:
                w, b = _pretrain_rbm(
                    key, h, layer.kernel, layer.bias,
                    lambda p: _updater(c["updater_name"], c["lr"], c["momentum"], p),
                    c["iterations"],
                )
            with torch.no_grad():
                layer.kernel.copy_(w)
                layer.bias.copy_(b)

    def population_fit(self, features, labels, seeds, learning_rates) -> list:
        raise NotImplementedError(
            "nn population training is not yet ported; see ROADMAP.md"
        )

    def fit_elastic(self, features, labels, manager, **kwargs) -> None:
        raise NotImplementedError(
            "nn elastic training (fit_elastic) is not yet ported; see ROADMAP.md"
        )

    # -- prediction ----------------------------------------------------------

    @torch.no_grad()
    def output(self, features: torch.Tensor) -> torch.Tensor:
        """The network's output rows on the features' device (the
        parameters move there once), computed in blocks of
        :data:`PREDICT_ROWS` rows, the last one padded with zero rows:
        every product runs at one shape, so a row's output does not
        depend on how many rows came with it (a served micro-batch and
        the batch run's test rows give the same bits)."""
        if self.net is None:
            raise ValueError("model not trained or loaded")
        if next(self.net.parameters()).device != features.device:
            self.net = self.net.to(features.device)
        x = features.to(torch.float32)
        if x.shape[0] == 0:
            return self.net(x)
        out = []
        for start in range(0, x.shape[0], PREDICT_ROWS):
            block = x[start:start + PREDICT_ROWS]
            n = block.shape[0]
            if n < PREDICT_ROWS:
                block = torch.cat([block, block.new_zeros((PREDICT_ROWS - n,) + block.shape[1:])])
            out.append(self.net(block)[:n])
        return torch.cat(out)

    def predict(self, features: torch.Tensor) -> torch.Tensor:
        return self.output(features)[:, 0].to(torch.float64)

    # -- persistence -----------------------------------------------------------

    def save(self, path: str) -> None:
        if self.config.get("config_model_format") == "mllib":
            raise NotImplementedError(_MLLIB_REFUSAL)
        if self.net is None:
            raise ValueError("model not trained or loaded")
        blob = codec.to_bytes(params_to_jax(self.net), keep_order=True)
        header = json.dumps({"arch": self._arch, "config": self.config})
        data = len(header).to_bytes(8, "little") + header.encode() + blob
        modelfiles.write_model_bytes(path, data)

    def load(self, path: str) -> None:
        raw = modelfiles.read_model_bytes(path)
        if raw[:2] == b"PK":
            raise NotImplementedError(
                "this is a DL4J ModelSerializer zip; its weights use closed ND4J "
                "serialization and cannot be imported — port the architecture with "
                "io.dl4j_compat.import_dl4j_architecture(path), set_config() it, "
                "and retrain (docs/MIGRATION.md)"
            )
        hlen = int.from_bytes(raw[:8], "little")
        header = json.loads(raw[8:8 + hlen].decode())
        self._arch = header["arch"]
        if "layer_types" not in self._arch:  # round-1 save files
            self._arch["layer_types"] = (
                ["dense"] * (len(self._arch["n_outs"]) - 1) + ["output"]
            )
        self.config = header["config"]
        net = self._build()
        tree = codec.from_bytes(raw[8 + hlen:])
        params_from_jax(tree, net)
        # restored into model.init's template: flax's creation order
        net.layout = creation_layout(net.layer_types)
        for p in net.parameters():
            p.requires_grad_(False)
        self.net = net
