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
features; every per-step scalar of a first-order rule is computed on the
host or stays on the device, so the loop makes no host round trip.

``lbfgs`` and ``line_gradient_descent`` are optax's value-function
transforms, ported from optax 0.2.6's source with its branch structure:
``lbfgs()`` at its defaults (``scale_by_lbfgs(memory_size=10,
scale_init_precond=True)``, ``scale(-1)``, then
``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy="one")``: Nocedal and Wright's interval search and
zoom with cubic, quadratic and bisection steps, Hager and Zhang's
approximate decrease test and the safe-step fallback), and ``sgd(1.0)``
chained with ``scale_by_backtracking_linesearch(max_backtracking_steps=15)``
(Armijo at slope_rtol 1e-4, decrease 0.8, increase 1.5, at most 1.0). The
L-BFGS two-loop product stays on the device; each line-search step
evaluates the objective (and, for the zoom, its gradient) at a trial
point and reads its value and slope back, and the search's accept and
reject decisions are taken on the host in numpy float32.
:attr:`NeuralNetworkClassifier.linesearch_steps` counts the steps of the
last fit's backprop updates, and ``linesearch_history`` holds each
update's (steps, step size). A decision taken at float32 roundoff can
branch differently from XLA's (``tests/test_torch_nn.py`` counts such
branches).

:meth:`NeuralNetworkClassifier.population_fit` trains P members (seed,
learning rate) at once: their parameters stacked on a member axis and
run through the network's own forward (batched products), each member's
init and dropout drawn from its own seed's threefry stream
(``parallel/population.train_nn_population``).
:meth:`NeuralNetworkClassifier.fit_elastic` runs the backprop iterations
in chunks through ``obs.failure.elastic_train``, checkpointing the
parameters and the optimizer state (``{"params", "opt"}``, a layout
only the port reads).

A model file is ``len(header)`` (8 bytes, little-endian), the JSON
header ``{"arch", "config"}``, then flax's msgpack of the parameter tree
(``checkpoint/codec.py``), byte-identical to the JAX package's for the
same parameters: the tree's key order is the JAX package's (flax's
creation order after ``init`` or ``load``, sorted after a trained fit).
:func:`params_from_jax` and :func:`params_to_jax` carry flax's nested
numpy trees across.

"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

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
    """flax ``Dense``: ``x @ kernel + bias``, kernel (in, out). A kernel
    (P, in, out) and bias (P, out) stacked on a member axis take input
    (P, ..., in), one product per member."""

    def __init__(self, n_in: int, n_out: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(n_in, n_out))
        self.bias = nn.Parameter(torch.zeros(n_out)) if use_bias else None

    def forward(self, x):
        k = self.kernel
        if k.dim() == 2:
            y = x @ k
            return y if self.bias is None else y + self.bias
        p = k.shape[0]
        y = (x.reshape(p, -1, x.shape[-1]) @ k).reshape(x.shape[:-1] + (k.shape[-1],))
        if self.bias is None:
            return y
        return y + self.bias.reshape((p,) + (1,) * (y.dim() - 2) + (-1,))


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
        """([P,] batch, time, features) -> ([P,] batch, time, n_out), from a
        zero carry (P: members, with the kernels stacked on it)."""
        ki = torch.cat([getattr(self, f"i{g}").kernel for g in _GATES], dim=-1)
        kh = torch.cat([getattr(self, f"h{g}").kernel for g in _GATES], dim=-1)
        bh = torch.cat([getattr(self, f"h{g}").bias for g in _GATES], dim=-1)
        if bh.dim() == 2:
            bh = bh.unsqueeze(-2)
        c = seq.new_zeros(seq.shape[:-2] + (self.n_out,))
        h = seq.new_zeros(seq.shape[:-2] + (self.n_out,))
        out = []
        for t in range(seq.shape[-2]):
            dh = torch.split(h @ kh + bh, self.n_out, dim=-1)
            di = torch.split(seq[..., t, :] @ ki, self.n_out, dim=-1)
            i = torch.sigmoid(dh[0] + di[0])
            f = torch.sigmoid(dh[1] + di[1])
            g = self.act(dh[2] + di[2])
            o = torch.sigmoid(dh[3] + di[3])
            c = f * c + i * g
            h = o * self.act(c)
            out.append(h)
        return torch.stack(out, dim=-2)


class _Net(nn.Module):
    """The configured layer stack, one module per layer named
    ``layer{i}`` (a :class:`_Dense`, or an :class:`_LSTMCell` for
    ``graves_lstm``), flax's parameter layout: ``layer{i}.kernel``,
    ``layer{i}.bias``, ``layer{i}.hf.kernel``, ...

    ``layout`` is the parameter tree's key order as the JAX package
    holds it (see :func:`params_to_jax`). Given parameters stacked on a
    leading member axis (``functional_call``), the forward pass runs every
    member on the same input at once: ``(P, ...)`` outputs."""

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

    def dropout_masks(self, key: threefry.Key, x_shape, device=None) -> List[torch.Tensor]:
        """The Bernoulli keep-masks of a training forward pass over input
        of shape ``x_shape``, one per layer whose dropout rate lies in
        (0, 1), from the key flax derives for its ``Dropout_{j}`` module
        out of ``key``; a batch of keys (``threefry.prng_keys``) gives
        each mask a leading member axis."""
        masks = []
        shape = tuple(int(s) for s in x_shape)
        last = len(self.n_outs) - 1
        j = 0
        for i, (ltype, n_out, drop) in enumerate(zip(self.layer_types, self.n_outs,
                                                     self.dropouts)):
            if ltype != "graves_lstm" and i == last and len(shape) == 3:
                shape = (shape[0], shape[-1])
            shape = shape[:-1] + (n_out,)
            if drop > 0.0:
                if drop < 1.0:
                    k = threefry.fold_in(key, threefry.static_hash(f"Dropout_{j}", 1))
                    masks.append(threefry.bernoulli(k, 1.0 - drop, shape, device))
                j += 1
        return masks

    def forward(self, x, dropout_key: Optional[threefry.Key] = None,
                n_layers: Optional[int] = None,
                dropout_masks: Optional[Sequence[torch.Tensor]] = None):
        """The forward pass; with ``dropout_key`` or ``dropout_masks``
        (training) each layer with a dropout rate masks its output with the
        mask flax draws for its ``Dropout_{j}`` module
        (:meth:`dropout_masks`). ``n_layers`` runs a prefix without
        dropout."""
        last = len(self.n_outs) if n_layers is None else n_layers
        if dropout_key is not None and dropout_masks is None and n_layers is None:
            dropout_masks = self.dropout_masks(dropout_key, tuple(x.shape), x.device)
        first = self.layer(0)
        kernel = first.ii.kernel if isinstance(first, _LSTMCell) else first.kernel
        lead = kernel.dim() - 2  # 1 with a member axis
        if lead:
            x = x.expand((kernel.shape[0],) + tuple(x.shape))
        m = 0
        for i in range(last):
            ltype, act, drop = self.layer_types[i], self.activations[i], self.dropouts[i]
            sequence = x.dim() - lead == 3
            if ltype == "graves_lstm":
                seq = self.layer(i)(x if sequence else x.unsqueeze(-2))
                x = seq if sequence else seq[..., -1, :]
            else:
                if i == len(self.n_outs) - 1 and sequence:
                    x = x[..., -1, :]
                x = _activation(act)(self.layer(i)(x))
            if drop > 0.0 and dropout_masks is not None:
                if drop < 1.0:
                    x = torch.where(dropout_masks[m], x / (1.0 - drop), torch.zeros_like(x))
                    m += 1
                else:
                    x = torch.zeros_like(x)
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


def _per_param(value, params) -> list:
    """A learning rate per parameter tensor: a float, or a (P,) tensor of
    member rates shaped to broadcast over each stacked (P, ...) tensor."""
    if isinstance(value, torch.Tensor):
        return [value.reshape((-1,) + (1,) * (p.dim() - 1)) for p in params]
    return [value] * len(params)


def _state_tensors(state: Dict, name: str, n: int, device) -> list:
    return [torch.as_tensor(state[f"{name}.{k}"], device=device) for k in range(n)]


class _Optimizer:
    """One optax transformation over a list of float32 tensors (the
    parameters in the JAX tree's leaf order). :meth:`update` takes the
    gradients and applies the step in place (``optax.apply_updates``).
    ``lr`` is a float, or a (P,) float32 tensor of member learning rates
    over parameters stacked on a leading member axis."""

    needs_value_fn = False
    _SLOTS = {"adam": ("mu", "nu"), "adagrad": ("sos",), "rmsprop": ("nu",),
              "nesterovs": ("trace",), "conjugate_gradient": ("prev_g", "prev_d")}

    def __init__(self, kind: str, lr, momentum: float, params):
        self.kind = kind
        if isinstance(lr, torch.Tensor):
            lr = lr.to(torch.float32)
            self.neg_lr, self.lr = _per_param(-lr, params), _per_param(lr, params)
        else:
            self.neg_lr = _per_param(float(_f32(-lr)), params)
            self.lr = _per_param(float(_f32(lr)), params)
        self.momentum = float(_f32(momentum))
        self.count = 0
        for name in self._SLOTS.get(kind, ()):
            fill = float(_f32(0.1)) if name == "sos" else 0.0
            setattr(self, name, [torch.full_like(p, fill) for p in params])

    def state_dict(self) -> Dict:
        out = {"count": np.int64(self.count)}
        for name in self._SLOTS.get(self.kind, ()):
            for k, t in enumerate(getattr(self, name)):
                out[f"{name}.{k}"] = t.detach().clone()
        return out

    def load_state_dict(self, state: Dict, device) -> None:
        self.count = int(state["count"])
        for name in self._SLOTS.get(self.kind, ()):
            setattr(self, name, _state_tensors(state, name, len(getattr(self, name)), device))

    @torch.no_grad()
    def update(self, params, grads) -> None:
        getattr(self, "_" + self.kind)(params, grads)

    def _sgd(self, params, grads):
        for k, (p, g) in enumerate(zip(params, grads)):
            p.add_(self.neg_lr[k] * g)

    def _nesterovs(self, params, grads):
        m = self.momentum
        for k, (p, g) in enumerate(zip(params, grads)):
            t = g + m * self.trace[k]
            self.trace[k] = t
            p.add_(self.neg_lr[k] * (g + m * t))

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
            p.add_(self.neg_lr[k] * u)

    def _adagrad(self, params, grads):
        eps = float(_f32(1e-7))
        for k, (p, g) in enumerate(zip(params, grads)):
            sos = g * g + self.sos[k]
            self.sos[k] = sos
            inv = torch.where(sos > 0, torch.rsqrt(sos + eps), torch.zeros_like(sos))
            p.add_(self.neg_lr[k] * (inv * g))

    def _rmsprop(self, params, grads):
        decay, eps = 0.9, float(_f32(1e-8))
        c = float(_f32(1 - decay))
        for k, (p, g) in enumerate(zip(params, grads)):
            nu = c * (g * g) + float(_f32(decay)) * self.nu[k]
            self.nu[k] = nu
            p.add_(self.neg_lr[k] * (torch.rsqrt(nu + eps) * g))

    def _conjugate_gradient(self, params, grads):
        """Polak-Ribière+: beta = max(g.(g - g_prev) / |g_prev|^2, 0),
        0 on the first step; d = -g + beta d_prev; the step lr * d."""
        num = sum(torch.sum(g * (g - pg)) for g, pg in zip(grads, self.prev_g))
        den = sum(torch.sum(pg * pg) for pg in self.prev_g)
        zero = torch.zeros((), dtype=torch.float32, device=den.device)
        beta = torch.where(den > 0.0,
                           torch.clamp(num / torch.clamp(den, min=1e-30), min=0.0), zero)
        dirs = [-g + beta * pd for g, pd in zip(grads, self.prev_d)]
        for k, (p, d) in enumerate(zip(params, dirs)):
            p.add_(self.lr[k] * d)
        self.prev_g, self.prev_d = list(grads), dirs


# -- optax's value-function transforms: L-BFGS and the line searches -----------


def _vdot(a, b) -> torch.Tensor:
    """``optax.tree.vdot``: the sum over leaves of each leaf's dot product
    (a 0-d device tensor)."""
    return sum(torch.sum(x * y) for x, y in zip(a, b))


def _read(*scalars) -> List[np.float32]:
    """0-d device tensors as host float32 scalars (one read-back)."""
    return [np.float32(v) for v in torch.stack([s.reshape(()) for s in scalars]).tolist()]


def _axpy(params, step, updates) -> list:
    """``optax.tree.add_scale(params, step, updates)``."""
    return [p + step * u for p, u in zip(params, updates)]


_F32 = np.float32
_INF = _F32(np.inf)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax's ``_cubicmin``: the critical point of the cubic through
    (a, fa), (b, fb), (c, fc) with slope fpa at a (NaN when it has none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    d1 = np.array([[dc ** 2, -(db ** 2)], [-(dc ** 3), db ** 3]], dtype=_F32)
    A, B = np.dot(d1, np.array([fb - fa - C * db, fc - fa - C * dc], dtype=_F32)) / denom
    radical = B * B - _F32(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (_F32(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """optax's ``_quadmin``: the critical point of the quadratic through
    (a, fa), (b, fb) with slope fpa at a."""
    C = fpa
    db = b - a
    B = (fb - fa - C * db) / (db ** 2)
    return a - C / (_F32(2.0) * B)


class _ZoomLinesearch:
    """``scale_by_zoom_linesearch`` at ``lbfgs()``'s settings: 20 steps, no
    maximal step, tol 0, increase 2, slope_rtol 1e-4, curv_rtol 0.9,
    approx_dec_rtol 1e-6, stepsize_precision 1e-5, initial guess 1.

    :meth:`search` runs optax's ``zoom_linesearch`` loop (the interval
    search of Nocedal and Wright's Algorithm 3.5, the zoom of 3.6, the
    safe step on failure): trial points and gradients on the device,
    every scalar of the state a numpy float32 on the host."""

    max_steps = 20
    increase_factor = _F32(2.0)
    slope_rtol = _F32(1e-4)
    curv_rtol = _F32(0.9)
    approx_dec_rtol = _F32(1e-6)
    interval_threshold = _F32(1e-5)

    def _decrease_error(self, stepsize, value_step, slope_step, value_init, slope_init):
        err = value_step - value_init - self.slope_rtol * stepsize * slope_init
        approx = slope_step - _F32(2 * 1e-4 - 1.0) * slope_init
        delta = value_step - value_init - self.approx_dec_rtol * abs(value_init)
        err = np.maximum(np.minimum(np.maximum(approx, delta), err), _F32(0.0))
        return _INF if np.isnan(err) else err

    def _curvature_error(self, slope_step, slope_init):
        err = np.maximum(abs(slope_step) - self.curv_rtol * abs(slope_init), _F32(0.0))
        return _INF if np.isnan(err) else err

    def search(self, params, updates, value, grad, value_and_grad):
        """``(stepsize, value, grad, steps)`` at the accepted point along
        ``updates`` from ``params``; ``value`` and ``grad`` are the
        objective's at ``params`` (``value`` a 0-d device tensor)."""
        (value_init, slope_init) = _read(value, _vdot(updates, grad))
        st = dict(count=0, stepsize=_F32(0.0), value=value_init, grad=grad,
                  slope=slope_init, decrease_error=_INF, curvature_error=_INF,
                  interval_found=False, done=False, failed=False,
                  low=_F32(0.0), value_low=value_init, slope_low=slope_init,
                  high=_F32(0.0), value_high=value_init, slope_high=slope_init,
                  cubic_ref=_F32(0.0), value_cubic_ref=value_init,
                  safe_stepsize=_F32(0.0), safe_value=value_init, safe_grad=grad)

        def on_line(stepsize):
            v, g = value_and_grad(_axpy(params, float(stepsize), updates))
            v, slope = _read(v, _vdot(g, updates))
            return v, g, slope

        with np.errstate(all="ignore"):
            while not (st["done"] or st["failed"]):
                if st["interval_found"]:
                    self._zoom(st, on_line, value_init, slope_init)
                else:
                    self._search_interval(st, on_line, value_init, slope_init)
                if st["failed"]:
                    # the safe step: a point of sufficient decrease, if any
                    if st["safe_stepsize"] > 0.0 or np.isinf(st["decrease_error"]):
                        st["stepsize"] = st["safe_stepsize"]
                        st["value"] = st["safe_value"]
                        st["grad"] = st["safe_grad"]
        return st["stepsize"], st["value"], st["grad"], st["count"]

    def _search_interval(self, st, on_line, value_init, slope_init):
        it = st["count"]
        prev_step, prev_value, prev_slope = st["stepsize"], st["value"], st["slope"]
        new_step = _F32(1.0) if it == 0 else self.increase_factor * prev_step
        v, g, slope = on_line(new_step)
        dec = self._decrease_error(new_step, v, slope, value_init, slope_init)
        curv = self._curvature_error(slope, slope_init)
        err = np.maximum(dec, curv)
        if dec <= 0.0:
            st.update(safe_stepsize=new_step, safe_value=v, safe_grad=g)
        set_high = bool((dec > 0.0) or ((v >= prev_value) and it > 0))
        set_low = bool((slope >= 0.0) and not set_high)
        if set_low:
            low, high = (new_step, v, slope), (prev_step, prev_value, prev_slope)
        else:
            low, high = (prev_step, prev_value, prev_slope), (new_step, v, slope)
        found = set_high or set_low or err <= 0.0
        done = bool(err <= 0.0)
        st.update(count=it + 1, stepsize=new_step, value=v, grad=g, slope=slope,
                  decrease_error=dec, curvature_error=curv, interval_found=found,
                  done=done, failed=bool(it + 1 >= self.max_steps and not done),
                  low=low[0], value_low=low[1], slope_low=low[2],
                  high=high[0], value_high=high[1], slope_high=high[2],
                  cubic_ref=low[0], value_cubic_ref=low[1])

    def _zoom(self, st, on_line, value_init, slope_init):
        it = st["count"]
        low, value_low, slope_low = st["low"], st["value_low"], st["slope_low"]
        high, value_high, slope_high = st["high"], st["value_high"], st["slope_high"]
        delta = abs(high - low)
        left, right = min(high, low), max(high, low)
        cubic_chk, quad_chk = _F32(0.2) * delta, _F32(0.1) * delta
        too_small = bool(delta <= self.interval_threshold)
        middle_cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                                 st["cubic_ref"], st["value_cubic_ref"])
        use_cubic = bool((middle_cubic > left + cubic_chk) & (middle_cubic < right - cubic_chk))
        middle_quad = _quadmin(low, value_low, slope_low, high, value_high)
        use_quad = (not use_cubic) and bool((middle_quad > left + quad_chk)
                                            & (middle_quad < right - quad_chk))
        if use_cubic:
            middle = _F32(middle_cubic)
        elif use_quad:
            middle = _F32(middle_quad)
        else:
            middle = (low + high) / _F32(2.0)
        v, g, slope = on_line(middle)
        dec = self._decrease_error(middle, v, slope, value_init, slope_init)
        curv = self._curvature_error(slope, slope_init)
        err = np.maximum(dec, curv)
        if dec <= 0.0 and v < st["safe_value"]:
            st.update(safe_stepsize=middle, safe_value=v, safe_grad=g)
        done = bool(err <= 0.0)
        set_high_to_middle = bool((dec > 0.0) or (v >= value_low))
        set_high_to_low = bool(slope * (high - low) >= 0.0) and not set_high_to_middle
        new_high = (middle, v, slope) if set_high_to_middle else (high, value_high, slope_high)
        if set_high_to_low:
            new_high = (low, value_low, slope_low)
        new_low = (low, value_low, slope_low) if set_high_to_middle else (middle, v, slope)
        cubic = (high, value_high) if set_high_to_middle or set_high_to_low else (low, value_low)
        presumably_failed = (it + 1 >= self.max_steps) or (
            too_small and st["safe_stepsize"] > 0.0)
        st.update(count=it + 1, stepsize=middle, value=v, grad=g, slope=slope,
                  decrease_error=dec, curvature_error=curv, done=done,
                  failed=bool(presumably_failed and not done),
                  low=new_low[0], value_low=new_low[1], slope_low=new_low[2],
                  high=new_high[0], value_high=new_high[1], slope_high=new_high[2],
                  cubic_ref=cubic[0], value_cubic_ref=cubic[1])


class _Lbfgs:
    """``optax.lbfgs()``: ``scale_by_lbfgs(memory_size=10,
    scale_init_precond=True)``, ``scale(-1)``, then the zoom line search;
    the step is applied in place. The memory of parameter and gradient
    differences and the two-loop product stay on the device."""

    needs_value_fn = True
    memory_size = 10

    def __init__(self, params):
        m = self.memory_size
        self.count = 0
        self.prev_params = [torch.zeros_like(p) for p in params]
        self.prev_updates = [torch.zeros_like(p) for p in params]
        self.dw = [p.new_zeros((m,) + tuple(p.shape)) for p in params]
        self.du = [p.new_zeros((m,) + tuple(p.shape)) for p in params]
        self.rho = params[0].new_zeros((m,))
        self.linesearch = _ZoomLinesearch()
        #: (line-search steps, step size) of each update
        self.history: List[tuple] = []

    def state_dict(self) -> Dict:
        out = {"count": np.int64(self.count), "rho": self.rho.clone()}
        for name in ("prev_params", "prev_updates", "dw", "du"):
            for k, t in enumerate(getattr(self, name)):
                out[f"{name}.{k}"] = t.detach().clone()
        return out

    def load_state_dict(self, state: Dict, device) -> None:
        self.count = int(state["count"])
        self.rho = torch.as_tensor(state["rho"], device=device)
        for name in ("prev_params", "prev_updates", "dw", "du"):
            setattr(self, name, _state_tensors(state, name, len(getattr(self, name)), device))

    def _precondition(self, updates, identity_scale, memory_idx: int) -> list:
        """optax's ``_precondition_by_lbfgs``: the two-loop recursion."""
        m = self.memory_size
        indices = [(memory_idx + i) % m for i in range(m)]
        vec = list(updates)
        alphas = {}
        for idx in reversed(indices):
            alpha = self.rho[idx] * _vdot([d[idx] for d in self.dw], vec)
            vec = [v + (-alpha) * d[idx] for v, d in zip(vec, self.du)]
            alphas[idx] = alpha
        vec = [identity_scale * v for v in vec]
        for idx in indices:
            beta = self.rho[idx] * _vdot([d[idx] for d in self.du], vec)
            vec = [v + (alphas[idx] - beta) * d[idx] for v, d in zip(vec, self.dw)]
        return vec

    @torch.no_grad()
    def step(self, params, grads, value, value_and_grad, value_only) -> None:
        m = self.memory_size
        memory_idx, prev_idx = self.count % m, (self.count - 1) % m
        if self.count > 0:
            dp = [p - q for p, q in zip(params, self.prev_params)]
            du = [g - q for g, q in zip(grads, self.prev_updates)]
            vdot = _vdot(du, dp)
            weight = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
        else:
            dp = [torch.zeros_like(p) for p in params]
            du = [torch.zeros_like(p) for p in params]
            weight = torch.zeros((), dtype=torch.float32, device=params[0].device)
        for mem, d in zip(self.dw, dp):
            mem[prev_idx] = d
        for mem, d in zip(self.du, du):
            mem[prev_idx] = d
        self.rho[prev_idx] = weight
        if self.count > 0:
            numerator = _vdot(du, dp)
            denominator = sum(torch.sum(d * d) for d in du)
            identity_scale = torch.where(denominator > 0.0, numerator / denominator,
                                         torch.ones_like(numerator))
        else:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            identity_scale = torch.clamp(1.0 / norm, max=1.0)
        direction = [-v for v in self._precondition(grads, identity_scale, memory_idx)]
        self.count += 1
        self.prev_params = [p.detach().clone() for p in params]
        self.prev_updates = [g.detach().clone() for g in grads]
        stepsize, _v, _g, steps = self.linesearch.search(params, direction, value, grads,
                                                         value_and_grad)
        self.history.append((steps, float(stepsize)))
        for p, d in zip(params, direction):
            p.add_(float(stepsize) * d)


class _BacktrackingGD:
    """``chain(sgd(1.0), scale_by_backtracking_linesearch(15))`` at its
    defaults: the direction is the negative gradient, the step the largest
    of ``min(1.5 lr_prev, 1)`` times powers of 0.8 (at most 15 cuts) that
    meets Armijo's condition; 0 when every trial was non-finite. Applied
    in place; the trial values are read back one at a time."""

    needs_value_fn = True
    max_steps = 15

    def __init__(self, params):
        self.learning_rate = _F32(1.0)
        #: (line-search steps, step size) of each update
        self.history: List[tuple] = []

    def state_dict(self) -> Dict:
        return {"learning_rate": np.float32(self.learning_rate)}

    def load_state_dict(self, state: Dict, device) -> None:
        self.learning_rate = _F32(np.asarray(state["learning_rate"]))

    @torch.no_grad()
    def step(self, params, grads, value, value_and_grad, value_only) -> None:
        direction = [-g for g in grads]
        value, slope = _read(value, _vdot(direction, grads))
        lr = min(_F32(1.5) * self.learning_rate, _F32(1.0))
        error, it = _INF, 0
        with np.errstate(all="ignore"):
            while not (error <= 0.0) and it <= self.max_steps:
                if it > 0:
                    lr = _F32(0.8) * lr
                (new_value,) = _read(value_only(_axpy(params, float(lr), direction)))
                error = new_value - _F32(1.0) * value - lr * _F32(1e-4) * slope
                error = _INF if np.isnan(error) else max(error, _F32(0.0))
                it += 1
        self.learning_rate = _F32(0.0) if np.isinf(error) else lr
        self.history.append((it, float(self.learning_rate)))
        for p, d in zip(params, direction):
            p.add_(float(self.learning_rate) * d)


def _optimizer(algo: str, updater_name: str, lr: float, momentum: float, params):
    """``config_optimization_algo``'s transform: lbfgs and
    line_gradient_descent are optax's value-function transforms
    (``needs_value_fn``), conjugate_gradient runs PR+ CG, every other
    value the configured updater (unknown names fall back to nesterovs)."""
    if algo == "lbfgs":
        return _Lbfgs(params)
    if algo == "line_gradient_descent":
        return _BacktrackingGD(params)
    if algo == "conjugate_gradient":
        return _Optimizer("conjugate_gradient", lr, momentum, params)
    return _updater(updater_name, lr, momentum, params)


def _updater(name: str, lr, momentum: float, params):
    return _Optimizer(name if name in _UPDATERS else "nesterovs", lr, momentum, params)


def _objective(loss_of: Callable[[list], torch.Tensor]):
    """``(value_and_grad, value_only)`` of a loss over a parameter list,
    evaluated at trial parameters (a value-function transform's calls)."""

    def value_and_grad(ps):
        with torch.enable_grad():
            ps = [p.detach().requires_grad_(True) for p in ps]
            value = loss_of(ps)
            grads = torch.autograd.grad(value, ps)
        return value.detach(), list(grads)

    def value_only(ps):
        with torch.no_grad():
            return loss_of(ps)

    return value_and_grad, value_only


def _train_step(tx, params, loss_of) -> torch.Tensor:
    """One optimizer step of ``tx`` on ``params`` (in place) for the loss
    ``loss_of(params)``; returns the loss at the step's start."""
    value_and_grad, value_only = _objective(loss_of)
    value, grads = value_and_grad(params)
    if tx.needs_value_fn:
        tx.step(params, grads, value, value_and_grad, value_only)
    else:
        tx.update(params, grads)
    return value


# -- greedy layerwise pretraining ------------------------------------------------


def _pretrain_ae(key, h, kernel, bias, act_name, make_tx, iterations):
    """Tied-weight denoising autoencoder on activations ``h``: encode
    ``act((h * keep) @ W + b)``, decode ``z @ W.T + c``, minimize the MSE
    to ``h``; keep ~ Bernoulli(0.7) from ``fold_in(key, it)``. The
    configured algorithm applies, the value-function ones included.
    Returns the trained (W, b)."""
    act = _activation(act_name)
    # the JAX tree {"W", "b", "c"} in its sorted leaf order
    params = [kernel.detach().clone(), bias.detach().clone(),
              torch.zeros(h.shape[1], dtype=h.dtype, device=h.device)]
    tx = make_tx(params)
    for it in range(int(iterations)):
        keep = threefry.bernoulli(threefry.fold_in(key, it), 1.0 - _AE_CORRUPTION,
                                  tuple(h.shape), h.device).to(h.dtype)

        def loss_of(ps, keep=keep):
            W, b, c = ps
            z = act((h * keep) @ W + b)
            return torch.mean((z @ W.T + c - h) ** 2)

        _train_step(tx, params, loss_of)
    return params[0], params[1]


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
        #: line-search steps the last fit took (lbfgs, line_gradient_descent)
        self.linesearch_steps = 0
        #: (line-search steps, step size) of each backprop update of the last fit
        self.linesearch_history: List[tuple] = []

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

    def _prepare_fit(self, features, labels, init: Optional[Dict] = None):
        """The front half every fit shares: config, architecture, the
        initial draw (``init``, flax's numpy tree, replaces it, so a run
        can start from another package's ``model.init``) and greedy
        pretraining. Returns ``(net, scalars, x, one-hot y, rng, loss)``."""
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
        loss = _loss_fn(self.config.get("config_loss_function", "mse"),
                        weight_pos=c["weight_pos"], weight_neg=c["weight_neg"])
        self.linesearch_steps = 0
        self.linesearch_history = []
        if c["pretrain"]:
            self._greedy_pretrain(net, x, c, rng)
        return net, c, x, y, rng, loss

    @staticmethod
    def _backprop_params(net: _Net):
        """(module names, parameter tensors) in the JAX tree's leaf order."""
        paths = _leaf_paths(_sorted_layout(net.layout))
        return [".".join(p[1:]) for p in paths], [_parameter(net, p) for p in paths]

    def _backprop(self, net, names, params, tx, loss, x, y, rng, its) -> torch.Tensor:
        """Backprop iterations ``its`` (absolute: the index keys the
        dropout masks, so chunks replay the monolithic run); returns the
        last iteration's loss (a 0-d device tensor)."""
        value = None
        seen = len(getattr(tx, "history", ()))
        for it in its:
            masks = net.dropout_masks(threefry.fold_in(rng, it), tuple(x.shape), x.device)

            def loss_of(ps, masks=masks):
                pred = functional_call(net, dict(zip(names, ps)), (x,),
                                       {"dropout_masks": masks})
                return loss(pred, y)

            value = _train_step(tx, params, loss_of)
        made = getattr(tx, "history", [])[seen:]
        self.linesearch_history.extend(made)
        self.linesearch_steps += sum(steps for steps, _ in made)
        return value

    def _finish_fit(self, net: _Net, c: dict) -> None:
        if c["pretrain"] or c["backprop"]:
            # the JAX package's tree went through jax.tree_util
            net.layout = _sorted_layout(net.layout)
        for p in net.parameters():
            p.requires_grad_(False)
        self.net = net

    def _fit(self, features, labels, init: Optional[Dict] = None) -> None:
        net, c, x, y, rng, loss = self._prepare_fit(features, labels, init)
        if c["backprop"]:
            names, params = self._backprop_params(net)
            tx = _optimizer(c["algo"], c["updater_name"], c["lr"], c["momentum"], params)
            self._backprop(net, names, params, tx, loss, x, y, rng, range(c["iterations"]))
        self._finish_fit(net, c)

    def fit_elastic(self, features, labels, manager, save_every: int = 1,
                    max_restarts: int = 3, sentinel=None, chunk_iters: int = 10,
                    probe_on_failure: bool = True) -> None:
        """:meth:`fit` with mid-train checkpoint/restore: the backprop
        iterations run in ``chunk_iters`` chunks through
        ``obs.failure.elastic_train``, checkpointing ``{"params", "opt"}``
        (the parameters by module name, the optimizer's state) after each;
        absolute iteration indices keep the dropout masks on the
        monolithic run's trajectory, so a restored run lands on the same
        parameters. Pretraining runs up front, unchunked. Each chunk fires
        the ``device.step`` chaos point; its last loss feeds the
        sentinel."""
        from ..obs import chaos, events, failure

        net, c, x, y, rng, loss = self._prepare_fit(features, labels)
        if not c["backprop"]:
            self._finish_fit(net, c)
            return
        names, params = self._backprop_params(net)
        tx = _optimizer(c["algo"], c["updater_name"], c["lr"], c["momentum"], params)
        params0 = {n: p.detach().clone() for n, p in zip(names, params)}
        opt0 = tx.state_dict()
        iterations = c["iterations"]
        chunks = [(it0, min(int(chunk_iters), iterations - it0))
                  for it0 in range(0, iterations, int(chunk_iters))]

        def init_state():
            return {"params": dict(params0), "opt": dict(opt0)}

        def chunk_step(state, it0, n):
            events.event("train.nn_chunk", it0=int(it0), iters=int(n))
            chaos.maybe_fire("device.step")
            with torch.no_grad():
                for name, p in zip(names, params):
                    p.copy_(torch.as_tensor(state["params"][name], device=x.device))
            tx.load_state_dict(state["opt"], x.device)
            value = self._backprop(net, names, params, tx, loss, x, y, rng,
                                   range(it0, it0 + n))
            return ({"params": {name: p.detach().clone() for name, p in zip(names, params)},
                     "opt": tx.state_dict()}, value)

        state, _, _ = failure.elastic_train(
            manager, init_state, chunk_step, lambda: list(chunks),
            max_restarts=max_restarts, save_every=save_every, sentinel=sentinel,
            probe_on_failure=probe_on_failure,
        )
        with torch.no_grad():
            for name, p in zip(names, params):
                p.copy_(torch.as_tensor(state["params"][name], device=x.device))
        self._finish_fit(net, c)

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
        """Train P members, one per (init seed, learning rate) pair, at
        once (``parallel/population.train_nn_population``); returns the
        members' networks in member order. Each member follows what
        :meth:`fit` runs for ``config_seed=seeds[i]`` and
        ``config_learning_rate=learning_rates[i]``: its own init and
        dropout streams, the configured updater. Raises
        ``PopulationVmapUnsupported`` for greedy pretraining, a
        value-function algorithm (lbfgs, line_gradient_descent) and
        ``config_backprop=false``, where the population trains looped."""
        from ..parallel.population import PopulationVmapUnsupported, train_nn_population

        c = self._parse_scalars()
        if c["pretrain"]:
            raise PopulationVmapUnsupported(
                "greedy pretraining is a host-driven layer walk; population "
                "members with config_pretrain=true train looped"
            )
        if c["algo"] in ("lbfgs", "line_gradient_descent"):
            raise PopulationVmapUnsupported(
                f"optimization_algo={c['algo']} carries a value_fn closure; "
                "population members train looped"
            )
        if not c["backprop"]:
            raise PopulationVmapUnsupported(
                "config_backprop=false leaves nothing to scan; population "
                "members train looped"
            )
        ltypes, n_outs, acts, drops = self._parse_layers()
        x = torch.as_tensor(features).to(torch.float32)
        device = x.device
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
        loss = _loss_fn(self.config.get("config_loss_function", "mse"),
                        weight_pos=c["weight_pos"], weight_neg=c["weight_neg"])

        def make_net(seed: int) -> _Net:
            net = self._build(device)
            _init_params(net, seed, c["weight_init"], device)
            return net

        def make_optimizer(lrs, params):
            # the updater, as the JAX package's population engine builds it
            return _updater(c["updater_name"], lrs, c["momentum"], params)

        nets = train_nn_population(make_net, make_optimizer, loss, x, y, seeds,
                                   learning_rates, c["iterations"])
        for net in nets:
            net.layout = _sorted_layout(net.layout)
        return nets

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
