"""Decision-tree, random-forest and gradient-boosted-tree classifiers.

Twin of the JAX package's ``models/trees.py`` (histogram CART after
Spark MLlib 1.6's ``DecisionTree``/``RandomForest``/
``GradientBoostedTrees``; ``Classification/DecisionTreeClassifier.java``,
``RandomForestClassifier.java``). Binning and the host growers are
float64 numpy, copied from the JAX package so their trees are bit-equal:
MLlib's count-stride split sketch over the observed values
(:func:`find_splits_for_continuous_feature`), ``(lo, hi]`` bins, and
level-by-level growth from per-(node, feature, bin, class) histograms.
``backend='device'`` (``dt-tpu``, ``rf-tpu``, ``gbt-tpu``, or
``config_backend=device``) grows and predicts on the features' device
(``models/trees_device.py``); GBT predicts on the host with either
backend, as the JAX package does.

Config surface parity:

- DT requires all of ``config_max_bins``, ``config_impurity``
  (gini|entropy), ``config_max_depth``,
  ``config_min_instances_per_node`` to use custom values
  (DecisionTreeClassifier.java:103-120), else MLlib classification
  defaults (gini, maxDepth 5, maxBins 32, minInstances 1);
- RF additionally requires ``config_num_trees`` and
  ``config_feature_subset`` (auto|all|sqrt|log2|onethird), defaulting to
  100 trees and 'auto'; bootstrap and subset draws are seeded with
  MLlib's fixed seed 12345 (RandomForestClassifier.java:104);
- GBT requires ``config_num_iterations``, ``config_learning_rate`` and
  ``config_max_depth``, else 100 rounds, learning rate 0.1, depth 3;
- save/load write and read the JAX package's ``.npz`` layout (either
  package loads the other's files) and tolerate the reference's
  ``file://`` prefix (DecisionTreeClassifier.java:157-165).

``fit`` and ``predict`` take tensors; the rows are copied to the host as
float64 for binning (the JAX package bins the extractor's own dtype:
float64 on the host ``fe=`` paths, float32 rows on the fused path), and
``predict`` returns float64 labels on the features' device.

MLlib model directories (``io/mllib_format.py``): :meth:`load` of one
keeps the imported ensemble and predicts through its raw-threshold
descent; ``config_model_format=mllib`` saves one
(:meth:`DecisionTreeClassifier.export_mllib_dir`, binned thresholds
mapped back to their bin edges; an imported model re-exports as it is).
"""

from __future__ import annotations

import io
import json
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from . import base, trees_device
from ..io import mllib_format, modelfiles

_EPS = 1e-12


def find_splits_for_continuous_feature(samples: np.ndarray, num_splits: int) -> np.ndarray:
    """Candidate thresholds for one continuous feature, exactly as
    MLlib 1.6.2 computes them (``DecisionTree
    .findSplitsForContinuousFeature``): if there are at most
    ``num_splits`` distinct values, every distinct value is a threshold;
    otherwise a stride walk over the sorted (value, count) sequence
    emits the previous value whenever adding the current count would
    move the cumulative count further from the running target."""
    samples = np.asarray(samples, dtype=np.float64)
    values, counts = np.unique(samples, return_counts=True)
    if len(values) <= num_splits:
        return values.astype(np.float64, copy=True)
    stride = len(samples) / (num_splits + 1)  # Double division
    out: List[float] = []
    target = stride
    current = int(counts[0])
    for index in range(1, len(values)):
        previous = current
        current += int(counts[index])
        if abs(previous - target) < abs(current - target):
            out.append(float(values[index - 1]))
            target += stride
    return np.array(out, dtype=np.float64)


def _impurity(counts: np.ndarray, kind: str) -> np.ndarray:
    """counts: (..., n_classes) -> impurity (...)."""
    total = counts.sum(axis=-1, keepdims=True)
    p = counts / np.maximum(total, _EPS)
    if kind == "entropy":
        # MLlib's Entropy.log2 is log(x)/log(2), not a fused log2
        return -(p * (np.log(np.maximum(p, _EPS)) / math.log(2.0))).sum(axis=-1)
    return 1.0 - (p**2).sum(axis=-1)  # gini


class _Tree:
    """Flat-array binary tree over binned features."""

    __slots__ = ("feature", "threshold_bin", "left", "right", "prediction")

    def __init__(self):
        self.feature: List[int] = []
        self.threshold_bin: List[int] = []
        self.left: List[int] = []
        self.right: List[int] = []
        self.prediction: List[float] = []

    def add_node(self) -> int:
        self.feature.append(-1)
        self.threshold_bin.append(-1)
        self.left.append(-1)
        self.right.append(-1)
        self.prediction.append(0.0)
        return len(self.feature) - 1

    def to_arrays(self) -> Dict[str, np.ndarray]:
        return {
            "feature": np.array(self.feature, dtype=np.int32),
            "threshold_bin": np.array(self.threshold_bin, dtype=np.int32),
            "left": np.array(self.left, dtype=np.int32),
            "right": np.array(self.right, dtype=np.int32),
            "prediction": np.array(self.prediction, dtype=np.float64),
        }


def compute_bin_edges(features: np.ndarray, max_bins: int) -> np.ndarray:
    """Candidate split thresholds per feature: (d, max_bins-1), MLlib's
    sketch over the observed values with ``maxPossibleBins = min(maxBins,
    numExamples)`` (``DecisionTreeMetadata``). Features with fewer
    thresholds than ``max_bins - 1`` are padded with ``+inf``; padded
    candidates give an empty right child and fail the min-instances
    validity mask in both growers."""
    features = np.asarray(features, dtype=np.float64)
    n, d = features.shape
    num_splits = min(max_bins, n) - 1
    edges = np.full((d, max_bins - 1), np.inf, dtype=np.float64)
    for j in range(d):
        th = find_splits_for_continuous_feature(features[:, j], num_splits)
        edges[j, : len(th)] = th
    return edges


def bin_features(features: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """(n, d) continuous -> (n, d) int32 bin indices in [0, max_bins).

    ``side='left'``: a value equal to a threshold lands in the bin that
    threshold closes, so the split ``bin <= b`` sends it left — MLlib's
    ``(split(b-1), split(b)]`` bins (``TreePoint.findBin``)."""
    n, d = features.shape
    binned = np.empty((n, d), dtype=np.int32)
    for j in range(d):
        binned[:, j] = np.searchsorted(edges[j], features[:, j], side="left")
    return binned


def _grow_tree(
    binned: np.ndarray,
    labels: np.ndarray,
    max_bins: int,
    impurity: str,
    max_depth: int,
    min_instances: int,
    feature_subset: Optional[int],
    rng: np.random.RandomState,
) -> _Tree:
    """Level-by-level CART growth from vectorized histograms: per node
    of a level, one bincount over (sample -> feature x bin x class).
    A node draws its feature subset from ``rng`` when it is about to
    split, so the draws interleave with the caller's bootstraps."""
    n, d = binned.shape
    tree = _Tree()
    root = tree.add_node()
    active = {root: np.arange(n)}

    for _depth in range(max_depth):
        if not active:
            break
        next_active: Dict[int, np.ndarray] = {}
        for node_id, idx in active.items():
            y = labels[idx]
            pos = float(y.sum())
            tree.prediction[node_id] = 1.0 if pos * 2 > len(idx) else 0.0
            if len(idx) < 2 * min_instances or pos == 0 or pos == len(idx):
                continue
            feats = (
                np.sort(rng.choice(d, size=feature_subset, replace=False))
                if feature_subset is not None and feature_subset < d
                else np.arange(d)
            )
            sub = binned[idx][:, feats]  # (m, f)
            m, f = sub.shape
            flat = (np.arange(f)[None, :] * max_bins + sub) * 2 + y[:, None].astype(np.int64)
            hist = np.bincount(flat.ravel(), minlength=f * max_bins * 2).reshape(
                f, max_bins, 2)
            # cumulative over bins: candidate split "bin <= b" for b < max_bins-1
            cum = hist.cumsum(axis=1)  # (f, bins, 2)
            total = cum[:, -1:, :]
            left_counts = cum[:, :-1, :]  # (f, bins-1, 2)
            right_counts = total - left_counts
            nl = left_counts.sum(-1)
            nr = right_counts.sum(-1)
            valid = (nl >= min_instances) & (nr >= min_instances)
            parent_imp = _impurity(total[:, 0, :], impurity)[:, None]
            # MLlib association order (calculateGainForSplit):
            # impurity - lw*lImp - rw*rImp
            gain = (
                parent_imp
                - (nl / m) * _impurity(left_counts, impurity)
                - (nr / m) * _impurity(right_counts, impurity)
            )
            gain = np.where(valid, gain, -np.inf)
            best_flat = int(np.argmax(gain))
            bf, bb = divmod(best_flat, max_bins - 1)
            if not np.isfinite(gain[bf, bb]) or gain[bf, bb] <= 0:
                continue
            feat = int(feats[bf])
            go_left = binned[idx, feat] <= bb
            li, ri = tree.add_node(), tree.add_node()
            tree.feature[node_id] = feat
            tree.threshold_bin[node_id] = int(bb)
            tree.left[node_id] = li
            tree.right[node_id] = ri
            next_active[li] = idx[go_left]
            next_active[ri] = idx[~go_left]
        active = next_active

    # finalize predictions for any still-active leaves
    for node_id, idx in active.items():
        y = labels[idx]
        tree.prediction[node_id] = 1.0 if y.sum() * 2 > len(idx) else 0.0
    return tree


def _predict_tree(arrays: Dict[str, np.ndarray], binned: np.ndarray) -> np.ndarray:
    """Vectorized traversal: all samples walk the flat tree together."""
    n = binned.shape[0]
    node = np.zeros(n, dtype=np.int32)
    feature = arrays["feature"]
    for _ in range(64):  # depth bound
        is_leaf = feature[node] < 0
        if is_leaf.all():
            break
        f = np.maximum(feature[node], 0)
        go_left = binned[np.arange(n), f] <= arrays["threshold_bin"][node]
        nxt = np.where(go_left, arrays["left"][node], arrays["right"][node])
        node = np.where(is_leaf, node, nxt).astype(np.int32)
    return arrays["prediction"][node]


def _grow_regression_tree(
    binned: np.ndarray,
    residuals: np.ndarray,
    max_bins: int,
    max_depth: int,
    min_instances: int,
) -> _Tree:
    """Variance-reduction CART on binned features for GBT residuals: the
    per-bin statistics are (count, sum r), leaves predict the mean
    residual."""
    n, d = binned.shape
    tree = _Tree()
    root = tree.add_node()
    active = {root: np.arange(n)}

    for _depth in range(max_depth):
        if not active:
            break
        next_active: Dict[int, np.ndarray] = {}
        for node_id, idx in active.items():
            r = residuals[idx]
            tree.prediction[node_id] = float(r.mean())
            if len(idx) < 2 * min_instances:
                continue
            sub = binned[idx]  # (m, d)
            m = len(idx)
            flat = np.arange(d)[None, :] * max_bins + sub
            cnt = np.bincount(flat.ravel(), minlength=d * max_bins).reshape(d, max_bins)
            s1 = np.bincount(
                flat.ravel(), weights=np.repeat(r, d), minlength=d * max_bins
            ).reshape(d, max_bins)
            c_cnt, c_s1 = cnt.cumsum(axis=1), s1.cumsum(axis=1)
            nl = c_cnt[:, :-1]
            nr = m - nl
            sl = c_s1[:, :-1]
            sr = c_s1[:, -1:] - sl
            # SSE reduction: parent SSE - (left SSE + right SSE); the
            # sum-of-squares terms cancel, leaving the mean terms
            with np.errstate(divide="ignore", invalid="ignore"):
                score = sl**2 / np.maximum(nl, _EPS) + sr**2 / np.maximum(nr, _EPS)
            valid = (nl >= min_instances) & (nr >= min_instances)
            score = np.where(valid, score, -np.inf)
            bf, bb = divmod(int(np.argmax(score)), max_bins - 1)
            if not np.isfinite(score[bf, bb]):
                continue
            parent_score = c_s1[bf, -1] ** 2 / m
            if score[bf, bb] <= parent_score + 1e-12:
                continue  # no variance reduction
            go_left = binned[idx, bf] <= bb
            li, ri = tree.add_node(), tree.add_node()
            tree.feature[node_id] = int(bf)
            tree.threshold_bin[node_id] = int(bb)
            tree.left[node_id] = li
            tree.right[node_id] = ri
            next_active[li] = idx[go_left]
            next_active[ri] = idx[~go_left]
        active = next_active

    for node_id, idx in active.items():
        tree.prediction[node_id] = float(residuals[idx].mean())
    return tree


def _host_rows(x) -> np.ndarray:
    """A tensor's (or array's) values as a host float64 array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def _labels01(labels) -> np.ndarray:
    """{0, 1} labels rounded half up, float64."""
    return np.floor(_host_rows(labels) + 0.5)


def edge_distance(trees: List[Dict[str, np.ndarray]], edges: np.ndarray, features) -> np.ndarray:
    """(n,) the least ``|x[f] - edges[f, b]|`` over the split comparisons
    on each row's path through every tree (``inf`` for a row that meets
    none): how far a row's predictions are from moving when its features
    move. Takes either package's tree arrays and edges."""
    x = _host_rows(features)
    binned = bin_features(x, edges)
    rows = np.arange(x.shape[0])
    out = np.full(x.shape[0], np.inf)
    for t in trees:
        node = np.zeros(x.shape[0], dtype=np.int64)
        for _ in range(64):  # depth bound, as _predict_tree
            feature = t["feature"][node]
            split = feature >= 0
            if not split.any():
                break
            f = np.maximum(feature, 0)
            b = t["threshold_bin"][node]
            gap = np.abs(x[rows, f] - edges[f, np.clip(b, 0, edges.shape[1] - 1)])
            out = np.where(split, np.minimum(out, gap), out)
            nxt = np.where(binned[rows, f] <= b, t["left"][node], t["right"][node])
            node = np.where(split, nxt, node)
    return out


class DecisionTreeClassifier(base.Classifier):
    #: trees bin the extractor's own values (float64 on the host fe= paths)
    fit_dtype = None
    required_keys = (
        "config_max_bins",
        "config_impurity",
        "config_max_depth",
        "config_min_instances_per_node",
    )

    def __init__(self, backend: str = "host") -> None:
        """``backend='host'`` is the numpy reference grower; ``'device'``
        grows the forest on the features' device
        (``models/trees_device.py``; also selectable per run with the
        ``config_backend`` key). Both produce the same tree array format,
        so prediction and persistence are shared."""
        super().__init__()
        if backend not in ("host", "device"):
            raise ValueError(f"unknown tree backend: {backend!r}")
        self.backend = backend
        self.trees: List[Dict[str, np.ndarray]] = []
        self.edges: Optional[np.ndarray] = None
        self._params: Dict = {}
        # (device, packed (T, n_nodes) tensors) for predict_linked_forest,
        # built lazily and dropped whenever self.trees changes
        self._device_pack = None
        # a loaded MLlib model directory: raw continuous thresholds, so
        # prediction runs its own descent instead of the binned forest
        self._mllib = None

    #: the MLlib class tag this classifier accepts from a model directory
    _mllib_class = mllib_format.TREE_DT

    def _resolved_backend(self) -> str:
        """The run's backend: ``config_backend`` overrides the ctor
        choice; invalid values raise here, for fit and predict alike."""
        backend = self.config.get("config_backend", self.backend)
        if backend not in ("host", "device"):
            raise ValueError(f"unknown tree backend: {backend!r}")
        return backend

    # MLlib Strategy.defaultStrategy("Classification") values
    def _tree_params(self) -> Dict:
        c = self.config
        if all(k in c for k in self.required_keys):
            return {
                "max_bins": int(c["config_max_bins"]),
                "impurity": c["config_impurity"],
                "max_depth": int(c["config_max_depth"]),
                "min_instances": int(c["config_min_instances_per_node"]),
            }
        return {"max_bins": 32, "impurity": "gini", "max_depth": 5, "min_instances": 1}

    def _n_trees(self) -> int:
        return 1

    def _feature_subset(self, d: int) -> Optional[int]:
        return None

    def fit(self, features, labels) -> None:
        p = self._tree_params()
        self._params = p
        self._device_pack = None
        self._mllib = None  # training replaces any imported model
        x = _host_rows(features)
        y = _labels01(labels).astype(np.int64)
        self.edges = compute_bin_edges(x, p["max_bins"])
        binned = bin_features(x, self.edges)
        if self._resolved_backend() == "device":
            self._fit_device(binned, y, p, features.device)
            return
        rng = np.random.RandomState(12345)  # RandomForestClassifier.java:104
        n = len(y)
        self.trees = []
        for _t in range(self._n_trees()):
            idx = rng.randint(0, n, size=n) if self._n_trees() > 1 else np.arange(n)
            tree = _grow_tree(
                binned[idx], y[idx], p["max_bins"], p["impurity"], p["max_depth"],
                p["min_instances"], self._feature_subset(x.shape[1]), rng,
            )
            self.trees.append(tree.to_arrays())

    def _fit_device(self, binned: np.ndarray, y: np.ndarray, p: Dict,
                    device: torch.device) -> None:
        """Grow the forest on ``device``: bootstrap draws (one
        ``RandomState(12345)`` stream for all trees) and per-heap-slot
        feature masks (:func:`trees_device.draw_feature_masks`, a second
        stream) are set up on the host; the growth runs on the device."""
        trees_device._check_device_depth(p["max_depth"])  # before any launch
        n, d = binned.shape
        T = self._n_trees()
        rng = np.random.RandomState(12345)
        boot = rng.randint(0, n, size=(T, n)) if T > 1 else np.arange(n)[None, :]
        masks = trees_device.draw_feature_masks(
            T, trees_device.n_heap_nodes(p["max_depth"] - 1), d, self._feature_subset(d))
        forest = trees_device.grow_forest(
            torch.from_numpy(binned.astype(np.int64)).to(device),
            torch.from_numpy(y).to(device),
            torch.from_numpy(boot.astype(np.int64)).to(device),
            torch.from_numpy(masks).to(device),
            max_bins=p["max_bins"], impurity=p["impurity"], max_depth=p["max_depth"],
            min_instances=p["min_instances"],
        )
        self.trees = trees_device.heap_to_host_arrays(forest)

    def _binned(self, features) -> np.ndarray:
        if not self.trees or self.edges is None:
            raise ValueError("model not trained or loaded")
        return bin_features(_host_rows(features), self.edges)

    def _predict_mllib(self, features) -> torch.Tensor:
        """The imported ensemble's prediction (MLlib semantics over the
        raw float64 rows, on the host) on the features' device."""
        return torch.from_numpy(self._mllib.predict(_host_rows(features))).to(features.device)

    def predict(self, features) -> torch.Tensor:
        if self._mllib is not None:
            return self._predict_mllib(features)
        binned = self._binned(features)
        device = features.device
        if self._resolved_backend() == "device":
            # the whole forest walks on the device; votes are 0/1, so
            # the float32 mean is exact for any practical T
            if self._device_pack is None or self._device_pack[0] != device:
                self._device_pack = (device, trees_device.host_trees_to_device(
                    self.trees, device))
            votes = trees_device.predict_linked_forest(
                *self._device_pack[1], torch.from_numpy(binned.astype(np.int64)).to(device),
                max_iters=int(self._params["max_depth"]),
            )
            return (votes.mean(dim=0) > 0.5).to(torch.float64)
        votes = np.stack([_predict_tree(t, binned) for t in self.trees])
        return torch.from_numpy((votes.mean(axis=0) > 0.5).astype(np.float64)).to(device)

    # -- persistence (file:// prefix tolerated like the reference) -----

    @staticmethod
    def _strip_prefix(path: str) -> str:
        return path[7:] if path.startswith("file://") else path

    def export_mllib_dir(self, path: str) -> None:
        """Write this model as a Spark 1.6 MLlib model directory (the
        artifact ``DecisionTreeModel.load`` / ``RandomForestModel.load``
        consumes, DecisionTreeClassifier.java:163-165). A binned split
        ``bin <= b`` is ``value <= edges[feature, b]`` (``bin_features``'
        ``(lo, hi]`` bins), MLlib's own continuous-split predicate, so
        the exported model predicts as this one does. An imported model
        re-exports as it is."""
        if self._mllib is not None:
            mllib_format.write_tree_ensemble(
                path,
                self._mllib.model_class,
                self._mllib.trees,
                tree_weights=self._mllib.tree_weights,
                algo=self._mllib.algo,
                # kept verbatim, in Spark's capitalized spelling
                combining={"vote": "Vote", "sum": "Sum",
                           "average": "Average"}[self._mllib.combining],
            )
            return
        if not self.trees or self.edges is None:
            raise ValueError("model not trained or loaded")
        trees = []
        for t in self.trees:
            feat = np.asarray(t["feature"])
            leaf = feat < 0  # the growers' leaf marker
            safe_feat = np.maximum(feat, 0)
            thr_bin = np.clip(np.asarray(t["threshold_bin"]), 0, self.edges.shape[1] - 1)
            k = len(feat)
            trees.append({
                "feature": safe_feat,
                "threshold": np.where(leaf, np.inf, self.edges[safe_feat, thr_bin]),
                "left": np.where(leaf, np.arange(k), t["left"]),
                "right": np.where(leaf, np.arange(k), t["right"]),
                "leaf": leaf,
                "predict": np.asarray(t["prediction"], np.float64),
            })
        mllib_format.write_tree_ensemble(
            path, self._mllib_class, trees,
            tree_weights=self._export_tree_weights(len(trees)),
        )

    def _export_tree_weights(self, n_trees: int):
        return [1.0] * n_trees

    def save(self, path: str) -> None:
        path = self._strip_prefix(path)
        if self.config.get("config_model_format") == "mllib":
            # checked before the imported-model guard: with the explicit
            # format key, re-saving an imported directory is what the
            # user asked for
            modelfiles.delete_local_dir_target(path)
            self.export_mllib_dir(path)
            return
        if self._mllib is not None:
            raise ValueError(
                "this model was loaded from an MLlib model directory; "
                "re-export it with export_mllib_dir(path)"
            )
        modelfiles.delete_local_dir_target(path)
        meta = {"kind": self.__class__.__name__, "params": self._params,
                "config": self.config, "n_trees": len(self.trees)}
        flat = {f"tree{i}_{k}": v for i, t in enumerate(self.trees) for k, v in t.items()}
        buf = io.BytesIO()
        np.savez(buf, meta=json.dumps(meta), edges=self.edges, **flat)
        fname = path if path.endswith(".npz") else path + ".npz"
        modelfiles.write_model_bytes(fname, buf.getvalue())

    def load(self, path: str) -> None:
        path = self._strip_prefix(path)
        if mllib_format.is_model_dir(path):
            # a reference-deployment artifact (the directory
            # DecisionTreeClassifier.java:163-165 hands to
            # DecisionTreeModel.load)
            ens = mllib_format.read_tree_ensemble(path)
            if ens.model_class != self._mllib_class:
                raise ValueError(
                    f"model dir at {path} holds {ens.model_class}, but "
                    f"{self.__class__.__name__} loads {self._mllib_class}"
                )
            self._mllib = ens
            self.trees = []
            self.edges = None
            self._device_pack = None
            return
        self._mllib = None
        fname = path if path.endswith(".npz") else path + ".npz"
        data = np.load(io.BytesIO(modelfiles.read_model_bytes(fname)), allow_pickle=False)
        meta = json.loads(str(data["meta"]))
        if meta["kind"] != self.__class__.__name__:
            raise ValueError(
                f"model at {path} was saved by {meta['kind']}, "
                f"not {self.__class__.__name__}"
            )
        self._params = meta["params"]
        self.config = meta["config"]
        self.edges = data["edges"]
        self._device_pack = None
        self.trees = [
            {k: data[f"tree{i}_{k}"]
             for k in ("feature", "threshold_bin", "left", "right", "prediction")}
            for i in range(meta["n_trees"])
        ]


class RandomForestClassifier(DecisionTreeClassifier):
    # the reference's custom-config gate requires these six keys, with
    # the subset strategy under 'config_feature_subset'
    # (RandomForestClassifier.java:106-111)
    required_keys = DecisionTreeClassifier.required_keys + (
        "config_num_trees",
        "config_feature_subset",
    )
    _mllib_class = mllib_format.TREE_RF

    def _n_trees(self) -> int:
        c = self.config
        if all(k in c for k in self.required_keys):
            return int(c["config_num_trees"])
        return 100  # RandomForestClassifier.java:132-135

    def _feature_subset(self, d: int) -> Optional[int]:
        c = self.config
        strategy = (
            c["config_feature_subset"] if all(k in c for k in self.required_keys) else "auto"
        )
        # MLlib 1.6 RandomForest.selectFeatures: 'auto' means 'all' for
        # a single tree and sqrt for classification forests;
        # sqrt/log2/onethird use ceil; unknown strategies throw
        if strategy == "auto":
            strategy = "all" if self._n_trees() == 1 else "sqrt"
        if strategy == "all":
            return None
        if strategy == "sqrt":
            return max(1, int(np.ceil(np.sqrt(d))))
        if strategy == "log2":
            return max(1, int(np.ceil(np.log2(d))))
        if strategy == "onethird":
            return max(1, int(np.ceil(d / 3.0)))
        raise ValueError(f"unsupported feature subset strategy: {strategy}")


class GradientBoostedTreesClassifier(DecisionTreeClassifier):
    """Gradient-boosted trees with logistic loss (MLlib
    ``GradientBoostedTrees``; the reference's ClassifierTest.java:213,
    commented out there). Defaults follow MLlib 1.6
    ``BoostingStrategy.defaultParams("Classification")``: 100
    iterations, learning rate 0.1, depth-3 trees.

    F_0 = 0; each round fits a variance-reduction regression tree to the
    residual ``y - sigmoid(F)`` and adds ``lr * tree(x)`` to F.
    Prediction: ``F >= 0``.
    """

    required_keys = (
        "config_num_iterations",
        "config_learning_rate",
        "config_max_depth",
    )
    _mllib_class = mllib_format.TREE_GBT

    def _export_tree_weights(self, n_trees: int):
        # the boosting applies the learning rate to every round (F = sum
        # lr * t_i); MLlib's Sum combining computes sum(w_i * t_i), so
        # uniform lr weights reproduce F. The one difference from this
        # class's predict is the F == 0 boundary (MLlib: > 0 -> 1; here
        # >= 0 -> 1).
        return [float(self._params.get("learning_rate", 0.1))] * n_trees

    def _boost_params(self) -> Dict:
        c = self.config
        if all(k in c for k in self.required_keys):
            return {
                "num_iterations": int(c["config_num_iterations"]),
                "learning_rate": float(c["config_learning_rate"]),
                "max_depth": int(c["config_max_depth"]),
            }
        return {"num_iterations": 100, "learning_rate": 0.1, "max_depth": 3}

    def fit(self, features, labels) -> None:
        p = self._boost_params()
        bp = {"max_bins": 32, "min_instances": 1}
        self._params = {**p, **bp}
        self._device_pack = None
        self._mllib = None  # training replaces any imported model
        x = _host_rows(features)
        y = _labels01(labels)
        self.edges = compute_bin_edges(x, bp["max_bins"])
        binned = bin_features(x, self.edges)
        if self._resolved_backend() == "device":
            self._fit_device_boost(binned, y, p, bp, features.device)
            return
        F = np.zeros(len(y), dtype=np.float64)
        self.trees = []
        for _round in range(p["num_iterations"]):
            residual = y - 1.0 / (1.0 + np.exp(-F))
            tree = _grow_regression_tree(binned, residual, bp["max_bins"], p["max_depth"],
                                         bp["min_instances"])
            arrays = tree.to_arrays()
            self.trees.append(arrays)
            F += p["learning_rate"] * _predict_tree(arrays, binned)

    def _fit_device_boost(self, binned, y, p: Dict, bp: Dict, device: torch.device) -> None:
        """gbt-tpu: the boosting loop on ``device``
        (:func:`trees_device.boost_gbt`, one regression tree a round);
        trees come back through ``heap_to_host_arrays`` so prediction and
        persistence share the host format."""
        trees_device._check_device_depth(p["max_depth"])  # before any launch
        heaps = trees_device.boost_gbt(
            torch.from_numpy(binned.astype(np.int64)).to(device),
            torch.from_numpy(y.astype(np.float32)).to(device),
            rounds=p["num_iterations"], learning_rate=p["learning_rate"],
            max_bins=bp["max_bins"], max_depth=p["max_depth"],
            min_instances=bp["min_instances"],
        )
        self.trees = trees_device.heap_to_host_arrays(heaps)

    def predict(self, features) -> torch.Tensor:
        if self._mllib is not None:
            return self._predict_mllib(features)
        binned = self._binned(features)
        lr = self._params.get("learning_rate", 0.1)
        F = np.zeros(binned.shape[0], dtype=np.float64)
        for t in self.trees:
            F += lr * _predict_tree(t, binned)
        return torch.from_numpy((F >= 0.0).astype(np.float64)).to(features.device)
