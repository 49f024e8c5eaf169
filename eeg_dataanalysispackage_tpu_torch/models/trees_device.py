"""Histogram tree growth on the features' device: the whole forest at once.

Twin of the JAX package's ``models/trees_device.py`` (the ``-tpu``
growers), in PyTorch on the device the binned features lie on:

- nodes live in a **heap layout** (node ``i`` -> children ``2i+1``,
  ``2i+2``), so a tree of depth D is a set of fixed-shape arrays of
  length ``2^(D+1)-1``;
- each level is ONE batched matmul of the node/channel one-hots against
  the per-sample bin one-hots, building every node's (feature, bin,
  channel) histogram at once, then a first-max argmax over the
  (feature, bin) layout;
- a forest grows in chunks of ``tree_chunk`` trees batched along a
  leading axis (the JAX package's ``lax.map(..., batch_size=8)`` over a
  vmapped grower); each chunk gathers its own bootstrap view and builds
  its bin one-hots once, ``tree_chunk * n * d * max_bins * 4`` bytes.

The arithmetic reproduces XLA's on the CPU, which contracts a multiply
followed by an add into one fused multiply-add and computes ``log`` by
the Cephes polynomial: the classification growers' counts are exact
float32 integers, and their impurities and gains are built here from
IEEE float32 and float64 operations that give the same bits on the CPU
and on the card (:func:`_fma`, :func:`_xla_log`), so a near-tie resolves
as the JAX package's jitted grower resolves it. The regression grower
(``gbt-tpu``) sums float32 residuals: XLA's order for those sums cannot
be reproduced, so this one accumulates its histograms and their running
sums in float64 and rounds them to float32 once, the same on both
devices, and its trees follow the JAX package's within the tolerance
the tests state.

Host and device forests are each deterministic but not equal to each
other (the host random forest draws feature subsets lazily per splittable
node, this path a mask per heap slot, :func:`draw_feature_masks`); single
trees with no feature subsetting agree with the host grower.

:func:`grow_forest_sharded` grows a forest tree-parallel over a device
mesh (``parallel/mesh.py``), each device its block of trees, bit-equal to
:func:`grow_forest`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.device import resolve_device

_EPS = 1e-12

#: deepest tree the device backend accepts: heap storage is 2^(D+1)-1
#: slots, so beyond this the dense layout loses to the host grower's
#: active-frontier representation (MLlib allows maxDepth up to 30)
MAX_DEVICE_DEPTH = 12

#: the Cephes float32 ``logf`` coefficients XLA's CPU ``log`` evaluates
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
#: ``x / log(2)`` is compiled as a product with the float32 reciprocal
_INV_LN2 = float(np.float32(1.0) / np.float32(math.log(2.0)))


def n_heap_nodes(max_depth: int) -> int:
    return 2 ** (max_depth + 1) - 1


def _check_device_depth(max_depth: int) -> None:
    if max_depth > MAX_DEVICE_DEPTH:
        raise ValueError(
            f"device tree backend supports max_depth <= {MAX_DEVICE_DEPTH} "
            f"(heap storage is 2^(depth+1)-1 slots); got {max_depth} — "
            "use backend='host' for deeper trees"
        )


def draw_feature_masks(
    n_trees: int,
    n_nodes: int,
    d: int,
    subset: Optional[int],
    seed: int = 12345,
) -> np.ndarray:
    """(T, n_nodes, d) bool — per-heap-slot feature availability.

    ``n_nodes`` only needs to cover *internal* slots
    (``n_heap_nodes(max_depth - 1)``): the deepest level never splits.
    ``subset=None`` (or >= d) means all features everywhere. Host numpy,
    seeded like the reference's fixed RF seed
    (RandomForestClassifier.java:104): an argsort draw of
    ``RandomState(seed).rand(T, n_nodes, d)``.
    """
    if subset is None or subset >= d:
        return np.ones((n_trees, n_nodes, d), dtype=bool)
    rng = np.random.RandomState(seed)
    order = rng.rand(n_trees, n_nodes, d).argsort(axis=-1)
    return order < subset


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's contracted multiply-add
    (``b`` and ``c`` tensors or float32 constants): the product of two
    float32 values is exact in float64, so the sum rounds once there and
    once to float32."""
    b, c = ((x.double() if isinstance(x, torch.Tensor) else float(np.float32(x)))
            for x in (b, c))
    return (a.double() * b + c).float()


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` on the CPU for positive normal ``x``: the
    Cephes polynomial on the mantissa in [sqrt(0.5), sqrt(2)), its
    multiply-adds contracted (bit-equal to ``jax.jit(jnp.log)`` there;
    torch's ``log`` differs in the last bit on ~13% of inputs)."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    low = m < np.float32(0.707106781186547524)
    m = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.to(torch.float32)
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(m, p[0], p[1])
    y1 = _fma(m, p[3], p[4])
    y2 = _fma(m, p[6], p[7])
    y = _fma(y, m, p[2])
    y1 = _fma(y1, m, p[5])
    y2 = _fma(y2, m, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * np.float32(_LOG_Q1))
    return ((m - x2 * 0.5) + y) + e * np.float32(_LOG_Q2)


def _impurity(counts: torch.Tensor, kind: str) -> torch.Tensor:
    """counts (..., 2) -> impurity (...), float32: the class fractions'
    gini ``1 - (p0^2 + p1^2)`` or entropy ``-(p0 log2 p0 + p1 log2 p1)``,
    each sum of two products contracted as XLA contracts it."""
    total = counts.sum(dim=-1, keepdim=True)
    p = counts / total.clamp_min(_EPS)
    p0, p1 = p[..., 0], p[..., 1]
    if kind == "entropy":
        lg = _xla_log(p.clamp_min(_EPS)) * np.float32(_INV_LN2)
        return -_fma(p1, lg[..., 1], p0 * lg[..., 0])
    return 1.0 - _fma(p1, p1, p0 * p0)


def _grow_heap_tree(
    binned: torch.Tensor,  # (T, n, d) int64 in [0, max_bins)
    channel_w: torch.Tensor,  # (T, n, 2) per-sample channel weights
    *,
    max_bins: int,
    max_depth: int,
    node_pred_fn,
    split_fn,
) -> Dict[str, torch.Tensor]:
    """Shared level-by-level heap growth of T trees at once (the
    frontier mechanics both the classification and regression growers
    run); the histograms accumulate in ``channel_w``'s dtype.

    ``node_pred_fn(tot) -> (T, L)`` maps per-node channel totals
    ``tot (T, 2, L)`` to predictions. ``split_fn(hist2, tot, offset, L)
    -> (flat_score (T, L, d*(B-1)) with -inf at invalid, accept_fn)``
    scores candidate splits; ``accept_fn(best_score) -> (T, L) bool``
    applies the grower's acceptance rule (the shared loop adds only
    finiteness). ``torch.argmax`` returns the first maximal index, the
    host growers' tie-break over the (feature, bin) flat layout.
    """
    T, n, d = binned.shape
    B = max_bins
    n_nodes = n_heap_nodes(max_depth)
    dev = binned.device
    feature = torch.full((T, n_nodes), -1, dtype=torch.int32, device=dev)
    thresh = torch.full((T, n_nodes), -1, dtype=torch.int32, device=dev)
    pred = torch.zeros((T, n_nodes), dtype=torch.float32, device=dev)
    assign = torch.zeros((T, n), dtype=torch.int64, device=dev)  # all at the root

    oh_bins = (binned.unsqueeze(-1) == torch.arange(B, device=dev)).to(
        channel_w.dtype).reshape(T, n, d * B)

    for level in range(max_depth + 1):
        offset = 2**level - 1
        L = 2**level
        local = assign - offset
        live = (local >= 0) & (local < L)  # at this level & not a leaf
        # samples not at this level compare equal to no node: zero rows
        oh = (local.unsqueeze(-1) == torch.arange(L, device=dev)).to(channel_w.dtype)
        A = torch.cat([oh * channel_w[..., 0:1], oh * channel_w[..., 1:2]], dim=2)
        hist2 = torch.matmul(A.transpose(1, 2), oh_bins).reshape(T, 2, L, d, B)

        tot = hist2.sum(dim=4)[..., 0]  # (T, 2, L) — identical per feature
        pred[:, offset:offset + L] = node_pred_fn(tot)

        if level == max_depth:
            break  # deepest level: predictions only, no further splits

        flat_score, accept_fn = split_fn(hist2, tot, offset, L)
        best = torch.argmax(flat_score, dim=2)  # (T, L), first max
        best_score = torch.gather(flat_score, 2, best.unsqueeze(-1))[..., 0]
        bf = best // (B - 1)
        bb = best % (B - 1)

        splittable = torch.isfinite(best_score) & accept_fn(best_score)
        minus = torch.full_like(bf, -1)
        feature[:, offset:offset + L] = torch.where(splittable, bf, minus).to(torch.int32)
        thresh[:, offset:offset + L] = torch.where(splittable, bb, minus).to(torch.int32)

        # route live samples at split nodes to their heap children
        at = local.clamp(0, L - 1)
        node_split = live & torch.gather(splittable, 1, at)
        feat_of_sample = torch.gather(bf, 1, at)
        thr_of_sample = torch.gather(bb, 1, at)
        sample_bin = torch.gather(binned, 2, feat_of_sample.unsqueeze(-1))[..., 0]
        go_right = (sample_bin > thr_of_sample).to(torch.int64)
        assign = torch.where(node_split, 2 * assign + 1 + go_right, assign)

    return {"feature": feature, "threshold_bin": thresh, "prediction": pred}


def _grow_one(
    binned: torch.Tensor,  # (T, n, d) int64 in [0, max_bins)
    labels: torch.Tensor,  # (T, n) int in {0, 1}
    feature_mask: torch.Tensor,  # (T, internal nodes, d) bool
    *,
    max_bins: int,
    impurity: str,
    max_depth: int,
    min_instances: int,
) -> Dict[str, torch.Tensor]:
    """Classification trees (gini/entropy), batched over a leading tree
    axis as the JAX package vmaps its single-tree grower. Channels are
    the class indicators, so the shared histogram is the per-(node,
    feature, bin, class) count table (MLlib's aggregation shape)."""
    B = max_bins
    d = binned.shape[2]
    channel_w = torch.stack([labels == 0, labels == 1], dim=2).to(torch.float32)

    def node_pred_fn(tot):
        m = tot[:, 0] + tot[:, 1]
        pos = tot[:, 1]
        return (pos * 2 > m).to(torch.float32)

    def split_fn(hist2, tot, offset, L):
        hist = hist2.movedim(1, -1)  # (T, L, d, B, 2)
        node_counts = tot.movedim(1, -1)  # (T, L, 2)
        m = node_counts.sum(-1)
        pos = node_counts[..., 1]
        cum = torch.cumsum(hist, dim=3)  # integer counts: exact
        left = cum[:, :, :, :-1, :]  # split "bin <= b", b in [0, B-2]
        right = cum[:, :, :, -1:, :] - left
        nl = left.sum(-1)
        nr = right.sum(-1)
        valid = (nl >= min_instances) & (nr >= min_instances)
        valid &= feature_mask[:, offset:offset + L].unsqueeze(-1)
        parent_imp = _impurity(node_counts, impurity)  # (T, L)
        # MLlib association order: impurity - lw*lImp - rw*rImp
        # (InformationGainStats.calculateGainForSplit), each product
        # contracted into the subtraction as XLA compiles it
        mm = m.clamp_min(_EPS)[..., None, None]
        gain = _fma(-(nl / mm), _impurity(left, impurity),
                    parent_imp[..., None, None].expand_as(nl))
        gain = _fma(-(nr / mm), _impurity(right, impurity), gain)
        gain = torch.where(valid, gain, torch.full_like(gain, -math.inf))

        def accept(best_gain):
            return ((m >= 2 * min_instances) & (pos > 0) & (pos < m)
                    & (best_gain > 0))

        return gain.reshape(gain.shape[0], L, d * (B - 1)), accept

    return _grow_heap_tree(binned, channel_w, max_bins=max_bins, max_depth=max_depth,
                           node_pred_fn=node_pred_fn, split_fn=split_fn)


def grow_forest(
    binned: torch.Tensor,  # (n, d) int — the base (un-bootstrapped) data
    labels: torch.Tensor,  # (n,) int
    bootstrap: torch.Tensor,  # (T, n) int sample indices per tree
    feature_masks: torch.Tensor,  # (T, internal nodes, d) bool
    *,
    max_bins: int,
    impurity: str,
    max_depth: int,
    min_instances: int,
    tree_chunk: int = 8,
) -> Dict[str, torch.Tensor]:
    """Grow T trees on ``binned``'s device, ``tree_chunk`` at a time.

    The dataset is stored once; each chunk gathers its own bootstrap
    view, so peak memory is the chunk's (n, d*max_bins) bin one-hots —
    ``tree_chunk * n * d * max_bins * 4`` bytes — never a dense (T, n, d)
    replica of the training set. Returns (T, n_nodes) heap arrays."""
    _check_device_depth(max_depth)
    binned, labels = binned.long(), labels.long()
    bootstrap = bootstrap.long()
    chunks = []
    for start in range(0, bootstrap.shape[0], tree_chunk):
        boot = bootstrap[start:start + tree_chunk]
        chunks.append(_grow_one(
            binned[boot], labels[boot], feature_masks[start:start + tree_chunk],
            max_bins=max_bins, impurity=impurity, max_depth=max_depth,
            min_instances=min_instances,
        ))
    return {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}


def grow_forest_sharded(
    binned,  # (n, d) int — the base (un-bootstrapped) data
    labels,  # (n,) int
    bootstrap,  # (T, n) int sample indices per tree
    feature_masks,  # (T, internal nodes, d) bool
    *,
    mesh,
    max_bins: int,
    impurity: str,
    max_depth: int,
    min_instances: int,
) -> Dict[str, torch.Tensor]:
    """Tree-parallel forest growth over ``mesh``'s first axis.

    The forest axis is the natural parallel dimension (MLlib grows trees
    as independent jobs): each device grows ``T / n_devices`` trees
    through :func:`_grow_all_vmapped` on its own stream
    (``parallel/mesh.run_on_shards``), with
    the dataset and labels copied to it; ``T`` is padded up to a multiple
    of the axis with repeat trees, then trimmed, so any forest size works
    on any mesh. Returns :func:`grow_forest`'s (T, n_nodes) heap arrays,
    gathered in tree order to the mesh's first device."""
    _check_device_depth(max_depth)
    from ..parallel import mesh as pmesh

    devices = mesh.axis_devices(mesh.axis_names[0])
    n_dev = len(devices)
    bootstrap = torch.as_tensor(bootstrap)
    feature_masks = torch.as_tensor(feature_masks)
    T = bootstrap.shape[0]
    pad = (-T) % n_dev
    if pad:
        bootstrap = torch.cat([bootstrap, bootstrap[:pad]])
        feature_masks = torch.cat([feature_masks, feature_masks[:pad]])
    per = bootstrap.shape[0] // n_dev

    def shard(i, dev):
        block = slice(i * per, (i + 1) * per)
        return _grow_all_vmapped(
            torch.as_tensor(binned).to(dev), torch.as_tensor(labels).to(dev),
            bootstrap[block].to(dev), feature_masks[block].to(dev), max_bins=max_bins,
            impurity=impurity, max_depth=max_depth, min_instances=min_instances,
        )

    parts = pmesh.run_on_shards(devices, shard)
    return {k: pmesh.gather([p[k] for p in parts], devices[0])[:T] for k in parts[0]}


def _grow_all_vmapped(binned, labels, bootstrap, feature_masks, *, max_bins: int,
                      impurity: str, max_depth: int, min_instances: int):
    """Every tree of ``bootstrap`` grown at once on the inputs' device:
    :func:`grow_forest` with all trees in one chunk (the JAX package's
    vmapped grower)."""
    return grow_forest(binned, labels, bootstrap, feature_masks, max_bins=max_bins,
                       impurity=impurity, max_depth=max_depth, min_instances=min_instances,
                       tree_chunk=max(1, bootstrap.shape[0]))


def _grow_one_reg(
    binned: torch.Tensor,  # (n, d) int in [0, max_bins)
    residuals: torch.Tensor,  # (n,) float32
    *,
    max_bins: int,
    max_depth: int,
    min_instances: int,
) -> Dict[str, torch.Tensor]:
    """Variance-reduction regression tree in heap layout (the GBT grower
    — host twin: ``trees._grow_regression_tree``), (n_nodes,) arrays.

    The same shared frontier loop as :func:`_grow_one`, with channels
    (count, sum of residuals): the SSE-reduction argmax only needs
    ``sl^2/nl + sr^2/nr``. The histograms and their running sums are
    float64, each rounded to float32 once; the scores are float32, as
    the JAX package's. A split is accepted when the best score beats the
    parent's ``S^2/m`` by 1e-12 (in float32)."""
    B = max_bins
    d = binned.shape[1]
    r = residuals.to(torch.float32).double()
    channel_w = torch.stack([torch.ones_like(r), r], dim=1).unsqueeze(0)

    def node_pred_fn(tot):
        t = tot.float()
        return t[:, 1] / t[:, 0].clamp_min(_EPS)

    def split_fn(hist2, tot, offset, L):
        m, S = tot.float().unbind(1)  # (T, L)
        nl = torch.cumsum(hist2[:, 0], dim=3)[..., :-1].float()  # (T, L, d, B-1)
        sl = torch.cumsum(hist2[:, 1], dim=3)[..., :-1].float()
        nr = m[..., None, None] - nl
        sr = S[..., None, None] - sl
        score = sl * sl / nl.clamp_min(_EPS) + sr * sr / nr.clamp_min(_EPS)
        valid = (nl >= min_instances) & (nr >= min_instances)
        score = torch.where(valid, score, torch.full_like(score, -math.inf))
        parent_score = S * S / m.clamp_min(_EPS)

        def accept(best_score):
            return (m >= 2 * min_instances) & (best_score > parent_score + np.float32(1e-12))

        return score.reshape(score.shape[0], L, d * (B - 1)), accept

    tree = _grow_heap_tree(binned.long().unsqueeze(0), channel_w, max_bins=max_bins,
                           max_depth=max_depth, node_pred_fn=node_pred_fn, split_fn=split_fn)
    return {k: v[0] for k, v in tree.items()}


def _predict_heap_tree(feature, thresh, pred, binned, max_depth):
    """(n,) leaf values for one heap tree (shared walk)."""
    binned = binned.long()
    node = torch.zeros((binned.shape[0],), dtype=torch.int64, device=binned.device)
    for _ in range(max_depth):
        f = feature[node]
        is_leaf = f < 0
        sample_bin = torch.gather(binned, 1, f.clamp_min(0).long().unsqueeze(1))[:, 0]
        go_right = (sample_bin > thresh[node]).to(torch.int64)
        node = torch.where(is_leaf, node, 2 * node + 1 + go_right)
    return pred[node]


def boost_gbt(
    binned: torch.Tensor,  # (n, d) int
    labels: torch.Tensor,  # (n,) float in {0, 1}
    *,
    rounds: int,
    learning_rate: float,
    max_bins: int,
    max_depth: int,
    min_instances: int,
) -> Dict[str, torch.Tensor]:
    """The whole GBT boosting loop on ``binned``'s device, with no host
    round trip inside it: per round, residual = y - sigmoid(F), grow a
    regression tree (fixed-shape heap), F += lr * tree(x). Returns
    stacked heap arrays (rounds, n_nodes).

    The sigmoid is evaluated in float64 and rounded to float32 (the same
    bits on the CPU and the card; XLA's float32 logistic differs from it
    by an ulp on some inputs); the update is one contracted multiply-add,
    as XLA compiles it."""
    _check_device_depth(max_depth)
    binned = binned.long()
    y = labels.to(torch.float32)
    F = torch.zeros_like(y)
    trees = []
    for _ in range(rounds):
        residual = y - torch.sigmoid(F.double()).float()
        tree = _grow_one_reg(binned, residual, max_bins=max_bins, max_depth=max_depth,
                             min_instances=min_instances)
        contrib = _predict_heap_tree(tree["feature"], tree["threshold_bin"],
                                     tree["prediction"], binned, max_depth)
        F = _fma(contrib, learning_rate, F)
        trees.append(tree)
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def predict_forest(
    forest: Dict[str, torch.Tensor],
    binned: torch.Tensor,  # (n, d) int
    max_depth: int,
) -> torch.Tensor:
    """(T trees, n samples) heap walk -> (n,) mean vote in [0, 1]."""
    votes = torch.stack([
        _predict_heap_tree(f, t, p, binned, max_depth)
        for f, t, p in zip(forest["feature"], forest["threshold_bin"], forest["prediction"])
    ])
    return votes.mean(dim=0)


def predict_linked_forest(
    feature: torch.Tensor,  # (T, n_nodes) int, -1 = leaf
    thresh: torch.Tensor,  # (T, n_nodes) int
    left: torch.Tensor,  # (T, n_nodes) int
    right: torch.Tensor,  # (T, n_nodes) int
    pred: torch.Tensor,  # (T, n_nodes) float32
    binned: torch.Tensor,  # (n, d) int
    max_iters: int = 64,
) -> torch.Tensor:
    """(T, n) leaf values for explicit-link trees (the host storage
    format, ``trees._Tree.to_arrays``) — device inference for forests of
    any origin, including host-grown or loaded ones where the heap walk
    of :func:`predict_forest` does not apply. ``max_iters`` bounds the
    walk like the host ``_predict_tree``'s depth bound."""
    binned = binned.long()
    feature, thresh, left, right = (a.long() for a in (feature, thresh, left, right))
    n = binned.shape[0]
    rows = torch.arange(n, device=binned.device).unsqueeze(0)
    node = torch.zeros((feature.shape[0], n), dtype=torch.int64, device=binned.device)
    for _ in range(max_iters):
        fo = torch.gather(feature, 1, node)
        is_leaf = fo < 0
        sample_bin = binned[rows, fo.clamp_min(0)]
        go_left = sample_bin <= torch.gather(thresh, 1, node)
        nxt = torch.where(go_left, torch.gather(left, 1, node), torch.gather(right, 1, node))
        node = torch.where(is_leaf, node, nxt)
    return torch.gather(pred, 1, node)


def predict_linked_forest_chunked(
    feature, thresh, left, right, pred, binned,
    max_iters: int = 64, row_chunk: int = 8192,
):
    """:func:`predict_linked_forest` over blocks of ``row_chunk`` rows —
    the same result with a bounded working set. Requires
    ``n % row_chunk == 0``."""
    n = binned.shape[0]
    if n % row_chunk:
        raise ValueError(f"n {n} must be a multiple of row_chunk {row_chunk}")
    return torch.cat([
        predict_linked_forest(feature, thresh, left, right, pred,
                              binned[s:s + row_chunk], max_iters=max_iters)
        for s in range(0, n, row_chunk)
    ], dim=1)


def host_trees_to_device(trees: list, device=None):
    """Pad a list of host-format tree dicts (numpy arrays, from either
    package) to one (T, n_nodes) tensor set on ``device`` (``None`` ->
    ``cuda``) for :func:`predict_linked_forest`; padding nodes are leaves
    predicting 0 and are unreachable from the root."""
    dev = resolve_device(device)
    n_nodes = max(np.asarray(t["feature"]).shape[0] for t in trees)

    def pad(key, fill, dtype):
        out = np.full((len(trees), n_nodes), fill, dtype)
        for i, t in enumerate(trees):
            arr = np.asarray(t[key])
            out[i, : arr.shape[0]] = arr
        return torch.from_numpy(out).to(dev)

    return (
        pad("feature", -1, np.int32),
        pad("threshold_bin", -1, np.int32),
        pad("left", -1, np.int32),
        pad("right", -1, np.int32),
        pad("prediction", 0.0, np.float32),
    )


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def heap_to_host_arrays(forest: Dict) -> list:
    """Heap forest (tensors, or the JAX package's arrays) -> the host
    path's per-tree array dicts (explicit left/right links), so
    persistence and the host ``_predict_tree`` work unchanged on
    device-grown trees."""
    out = []
    feature = _numpy(forest["feature"]).astype(np.int32, copy=False)
    thresh = _numpy(forest["threshold_bin"]).astype(np.int32, copy=False)
    pred = _numpy(forest["prediction"]).astype(np.float64)
    n_nodes = feature.shape[1]
    for t in range(feature.shape[0]):
        split = feature[t] >= 0
        idx = np.arange(n_nodes)
        left = np.where(split, 2 * idx + 1, -1).astype(np.int32)
        right = np.where(split, 2 * idx + 2, -1).astype(np.int32)
        out.append({"feature": feature[t], "threshold_bin": thresh[t], "left": left,
                    "right": right, "prediction": pred[t]})
    return out
