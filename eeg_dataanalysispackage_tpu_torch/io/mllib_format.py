"""Spark MLlib 1.x on-disk model-directory interchange.

The port's own copy of the JAX package's ``io/mllib_format.py`` (the
reading, writing and remote routing are the same code, so a directory
either package writes is byte-for-byte the other's). The reference
persists its trained classifiers with MLlib's own ``model.save(sc,
path)`` (LogisticRegressionClassifier.java:144-152; SVMClassifier.java
analogous; ``"file://" + path`` for the tree family at
DecisionTreeClassifier.java:156-165, RandomForestClassifier.java
ditto), producing the MLlib *format version 1.0* model directory:

    <dir>/metadata/part-00000     one JSON object (+ _SUCCESS)
    <dir>/data/part-*.parquet     one small DataFrame (+ _SUCCESS)

This module reads — and, for fixtures and reverse migration, writes —
those directories, so a model saved by an existing reference
deployment loads drop-in (``load_clf=logreg&load_name=<dir>``) and a
model trained here can be handed back to a Spark 1.6 cluster
(``save_clf=true&config_model_format=mllib``).

Layouts (Spark 1.6.2, format class tags in the metadata JSON):

- GLM (``LogisticRegressionModel`` / ``SVMModel``): metadata
  ``{"class", "version": "1.0", "numFeatures", "numClasses"}``; data
  is one row ``(weights: VectorUDT, intercept: double,
  threshold: double?)``. The VectorUDT struct is
  ``(type: tinyint, size: int?, indices: array<int>?,
  values: array<double>)`` with type 1 = dense, 0 = sparse.
- Trees (``DecisionTreeModel``): metadata carries ``algo`` and
  ``numNodes`` at top level; data is one row per node:
  ``(treeId: int, nodeId: int, predict: (predict: double,
  prob: double), impurity: double, isLeaf: boolean,
  split: (feature: int, threshold: double, featureType: int,
  categories: array<double>)?, leftNodeId: int?, rightNodeId: int?,
  infoGain: double?)``. Continuous splits (featureType 0) route
  ``feature <= threshold`` to the left child.
- Ensembles (``RandomForestModel`` / ``GradientBoostedTreesModel``):
  same node rows distinguished by ``treeId``; metadata nests
  ``{"algo", "treeAlgo", "combiningStrategy", "treeWeights"}``.
  Combining: Vote = per-tree class majority (random forests),
  Sum = ``sign(sum(w_i * tree_i(x)))`` (GBT), Average for
  regression ensembles.

The parquet data files need ``pyarrow``, imported lazily: without it the
package still imports, and reading or writing a directory raises the
JAX package's message (:func:`_pq`). Categorical splits never occur in
the reference's pipelines (all 48 DWT features are continuous), so
importing a tree with a featureType-1 split raises rather than guessing
category semantics.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

GLM_LOGREG = "org.apache.spark.mllib.classification.LogisticRegressionModel"
GLM_SVM = "org.apache.spark.mllib.classification.SVMModel"
TREE_DT = "org.apache.spark.mllib.tree.model.DecisionTreeModel"
TREE_RF = "org.apache.spark.mllib.tree.model.RandomForestModel"
TREE_GBT = "org.apache.spark.mllib.tree.model.GradientBoostedTreesModel"

_FORMAT_VERSION = "1.0"


def _pq():
    try:
        import pyarrow  # noqa: F401
        import pyarrow.parquet as pq

        return pq
    except ImportError as e:
        raise ImportError(
            "MLlib model-directory interchange needs pyarrow for the "
            "parquet data files; the native npz formats "
            "(io/modelfiles.py) work without it"
        ) from e


def strip_file_prefix(path: str) -> str:
    """The reference prepends ``file://`` for the tree family
    (DecisionTreeClassifier.java:157); tolerate it everywhere."""
    return path[7:] if path.startswith("file://") else path


def _is_remote(path: str) -> bool:
    """Remoteness from the same dispatch that will serve the IO
    (io/modelfiles -> remote.filesystem_for): an unregistered scheme
    falls through to the local filesystem there, so it counts as local
    here too, and writer and reader route one URI alike."""
    from . import modelfiles

    return not modelfiles._is_local(path)


def _remote_fs(path: str):
    from . import modelfiles

    return modelfiles._fs_for(path)


def is_model_dir(path: str) -> bool:
    """True iff ``path`` looks like an MLlib model directory (has the
    ``metadata/`` part files). The classifiers use this to route
    ``load()`` between their native npz and this importer. Remote
    URIs are probed through the pluggable filesystem when it can
    list directories (``hdfs://`` — both drivers); listing-less
    schemes (plain http, the gs ranged-read adapter) return False
    and fall through to the byte-level npz path."""
    if _is_remote(path):
        fs = _remote_fs(path)
        if not hasattr(fs, "list_dir"):
            return False
        from .remote import RemoteIOError

        try:
            return any(
                name.startswith("part-")
                for name in fs.list_dir(path.rstrip("/") + "/metadata")
            )
        except (FileNotFoundError, OSError, RemoteIOError, ValueError):
            return False
    path = strip_file_prefix(path)
    meta = os.path.join(path, "metadata")
    return os.path.isdir(meta) and any(
        name.startswith("part-") for name in os.listdir(meta)
    )


def _ensure_local(path: str):
    """(local_dir, cleanup_fn): identity for local paths; for remote
    URIs, download the model directory's metadata/ and data/ entries
    into a temp dir (the reference's load-models-from-HDFS flow,
    DecisionTreeClassifier.java:163-165 against the Const.java
    namenode)."""
    if not _is_remote(path):
        return strip_file_prefix(path), (lambda: None)
    import shutil
    import tempfile

    fs = _remote_fs(path)
    if not hasattr(fs, "list_dir"):
        raise ValueError(
            f"loading an MLlib model directory from {path!r} needs a "
            f"filesystem with directory listing (local paths or "
            f"hdfs:// — WebHDFS and native drivers); stage it "
            f"locally for other schemes"
        )
    tmp = tempfile.mkdtemp(prefix="mllib_import_")
    try:
        base = path.rstrip("/")
        for sub in ("metadata", "data"):
            os.makedirs(os.path.join(tmp, sub), exist_ok=True)
            for name in fs.list_dir(f"{base}/{sub}"):
                with open(os.path.join(tmp, sub, name), "wb") as f:
                    f.write(fs.read_bytes(f"{base}/{sub}/{name}"))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return tmp, (lambda: shutil.rmtree(tmp, ignore_errors=True))


def read_metadata(path: str) -> dict:
    """Parse ``<dir>/metadata/part-*`` (first non-empty JSON line;
    Spark writes the object as a single line via json4s)."""
    meta_dir = os.path.join(strip_file_prefix(path), "metadata")
    parts = sorted(
        p for p in os.listdir(meta_dir) if p.startswith("part-")
    )
    if not parts:
        raise FileNotFoundError(f"no metadata part files under {meta_dir}")
    for part in parts:
        with open(os.path.join(meta_dir, part), "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    return json.loads(line)
    raise ValueError(f"empty metadata under {meta_dir}")


def _read_data_rows(path: str) -> List[dict]:
    pq = _pq()
    data_dir = os.path.join(strip_file_prefix(path), "data")
    files = sorted(
        os.path.join(data_dir, p)
        for p in os.listdir(data_dir)
        if p.endswith(".parquet")
    )
    if not files:
        raise FileNotFoundError(f"no parquet part files under {data_dir}")
    rows: List[dict] = []
    for f in files:
        rows.extend(pq.read_table(f).to_pylist())
    return rows


def _vector_to_np(v: dict) -> np.ndarray:
    """VectorUDT struct -> dense float64 array (type 1 = dense,
    0 = sparse with (size, indices, values))."""
    vtype = int(v["type"])
    values = np.asarray(v["values"] or [], dtype=np.float64)
    if vtype == 1:
        return values
    if vtype == 0:
        size = int(v["size"])
        out = np.zeros(size, dtype=np.float64)
        idx = np.asarray(v["indices"] or [], dtype=np.int64)
        out[idx] = values
        return out
    raise ValueError(f"unknown VectorUDT type tag {vtype}")


# ---------------------------------------------------------------- GLM


@dataclass
class GLMModel:
    model_class: str
    weights: np.ndarray  # (numFeatures,) float64
    intercept: float
    threshold: Optional[float]  # None == cleared (raw-score mode)
    num_features: int
    num_classes: int


def read_glm(path: str) -> GLMModel:
    """Load a GLM model directory written by
    ``LogisticRegressionModel.save`` / ``SVMModel.save`` (the
    reference's save/load seam, LogisticRegressionClassifier.java:
    144-152)."""
    path, cleanup = _ensure_local(path)
    try:
        return _read_glm_local(path)
    finally:
        cleanup()


def _read_glm_local(path: str) -> GLMModel:
    meta = read_metadata(path)
    cls = meta.get("class", "")
    if cls not in (GLM_LOGREG, GLM_SVM):
        raise ValueError(f"not a GLM classification model dir: {cls!r}")
    rows = _read_data_rows(path)
    if len(rows) != 1:
        raise ValueError(
            f"GLM data must be a single row; found {len(rows)}"
        )
    row = rows[0]
    weights = _vector_to_np(row["weights"])
    threshold = row.get("threshold")
    return GLMModel(
        model_class=cls,
        weights=weights,
        intercept=float(row["intercept"]),
        threshold=None if threshold is None else float(threshold),
        num_features=int(meta.get("numFeatures", weights.shape[0])),
        num_classes=int(meta.get("numClasses", 2)),
    )


def write_glm(
    path: str,
    model_class: str,
    weights: np.ndarray,
    intercept: float = 0.0,
    threshold: Optional[float] = 0.5,
    num_classes: int = 2,
) -> None:
    """Write a format-1.0 GLM model directory a Spark 1.6 cluster (or
    :func:`read_glm`) can load. Also the fixture generator for the
    import tests. ``path`` may be a remote URI (built locally, then
    uploaded file-by-file through io/modelfiles)."""
    materialize_model_dir(
        path,
        lambda local: _write_glm_local(
            local, model_class, weights, intercept, threshold,
            num_classes,
        ),
    )


def _write_glm_local(
    path: str,
    model_class: str,
    weights: np.ndarray,
    intercept: float,
    threshold: Optional[float],
    num_classes: int,
) -> None:
    pq = _pq()  # first: without pyarrow, its message
    import pyarrow as pa
    weights = np.asarray(weights, dtype=np.float64)
    _write_metadata(
        path,
        {
            "class": model_class,
            "version": _FORMAT_VERSION,
            "numFeatures": int(weights.shape[0]),
            "numClasses": int(num_classes),
        },
    )
    vec_t = pa.struct(
        [
            ("type", pa.int8()),
            ("size", pa.int32()),
            ("indices", pa.list_(pa.int32())),
            ("values", pa.list_(pa.float64())),
        ]
    )
    schema = pa.schema(
        [
            ("weights", vec_t),
            ("intercept", pa.float64()),
            ("threshold", pa.float64()),
        ]
    )
    row = {
        "weights": {
            "type": 1,
            "size": None,
            "indices": None,
            "values": weights.tolist(),
        },
        "intercept": float(intercept),
        "threshold": None if threshold is None else float(threshold),
    }
    _write_data(
        pq,
        pa.Table.from_pylist([row], schema=schema),
        path,
        spark_schema=_GLM_SPARK_SCHEMA,
    )


#: Spark SQL schema JSON for the GLM data table, embedded verbatim as
#: the ``org.apache.spark.sql.parquet.row.metadata`` footer key. Spark
#: 1.6's ``GLMClassificationModel.SaveLoadV1_0.loadData`` pattern-
#: matches ``Row(weights: Vector, ...)`` — without the ``udt`` entry
#: tagging the weights struct as VectorUDT, the row deserializes as a
#: plain struct and the match throws MatchError, so an exported
#: logreg/svm dir would not load on an actual cluster. Field order mirrors the parquet schema; ``metadata`` maps
#: are the empty defaults ``CatalystTypeConverters`` writes.
_GLM_SPARK_SCHEMA = {
    "type": "struct",
    "fields": [
        {
            "name": "weights",
            "type": {
                "type": "udt",
                "class": "org.apache.spark.mllib.linalg.VectorUDT",
                "pyClass": "pyspark.mllib.linalg.VectorUDT",
                "sqlType": {
                    "type": "struct",
                    "fields": [
                        {
                            "name": "type",
                            "type": "byte",
                            "nullable": False,
                            "metadata": {},
                        },
                        {
                            "name": "size",
                            "type": "integer",
                            "nullable": True,
                            "metadata": {},
                        },
                        {
                            "name": "indices",
                            "type": {
                                "type": "array",
                                "elementType": "integer",
                                "containsNull": False,
                            },
                            "nullable": True,
                            "metadata": {},
                        },
                        {
                            "name": "values",
                            "type": {
                                "type": "array",
                                "elementType": "double",
                                "containsNull": False,
                            },
                            "nullable": True,
                            "metadata": {},
                        },
                    ],
                },
            },
            "nullable": True,
            "metadata": {},
        },
        {
            "name": "intercept",
            "type": "double",
            "nullable": False,
            "metadata": {},
        },
        {
            "name": "threshold",
            "type": "double",
            "nullable": True,
            "metadata": {},
        },
    ],
}


# -------------------------------------------------------------- trees


@dataclass
class MLlibTreeEnsemble:
    """Imported tree family in nodeId-compacted array form; one dict
    per tree with arrays ``feature``/``threshold``/``left``/``right``/
    ``leaf``/``predict`` (leaf nodes self-loop so the fixed-iteration
    descent below is total)."""

    model_class: str
    algo: str
    trees: List[Dict[str, np.ndarray]]
    tree_weights: np.ndarray  # (n_trees,) float64
    combining: str  # "vote" | "sum" | "average"

    def predict(self, features: np.ndarray) -> np.ndarray:
        """Reference-semantics prediction over raw (continuous)
        features: TreeEnsembleModel.predict — Vote = per-tree class
        majority; Sum = ``1 if sum(w_i * t_i(x)) > 0 else 0`` (the
        GBT classification threshold); Average = weighted mean.

        Vote ties follow Spark 1.6 ``predictByVoting`` exactly: it
        takes ``maxBy`` over a ``mutable.HashMap[Int, Double]``, and
        ``maxBy`` keeps the FIRST maximum in the map's iteration
        order. For the binary vote keys {0, 1} that order is fixed by
        the hash table, not by tree order: with the initial 16-bucket
        table, byteswap32-improved Int hashing puts key 1 in bucket 6
        and key 0 in bucket 0, and ``entriesIterator`` walks buckets
        DOWNWARD from the highest populated index — so key 1 always
        iterates first and an exact weighted tie deterministically
        predicts class 1.0 (reachable for even-sized equal-weight
        forests)."""
        X = np.asarray(features, dtype=np.float64)
        per_tree = np.stack([_descend(t, X) for t in self.trees])
        w = self.tree_weights[:, None]
        if self.combining == "sum":
            total = (w * per_tree).sum(axis=0)
            return (total > 0.0).astype(np.float64)
        if self.combining == "vote":
            votes1 = ((per_tree > 0.5) * w).sum(axis=0)
            votes0 = ((per_tree <= 0.5) * w).sum(axis=0)
            # >= : the tie goes to class 1 (the JVM vote map's
            # iteration order above), never to class 0
            return (votes1 >= votes0).astype(np.float64)
        return (w * per_tree).sum(axis=0) / self.tree_weights.sum()


def _descend(tree: Dict[str, np.ndarray], X: np.ndarray) -> np.ndarray:
    n = X.shape[0]
    node = np.zeros(n, dtype=np.int64)
    rows = np.arange(n)
    # node count bounds the path length; leaves self-loop so extra
    # iterations are no-ops
    for _ in range(len(tree["leaf"])):
        leaf = tree["leaf"][node]
        if leaf.all():
            break
        go_left = X[rows, tree["feature"][node]] <= tree["threshold"][node]
        nxt = np.where(go_left, tree["left"][node], tree["right"][node])
        node = np.where(leaf, node, nxt)
    return tree["predict"][node]


def _nodes_to_tree(nodes: List[dict]) -> Dict[str, np.ndarray]:
    nodes = sorted(nodes, key=lambda r: int(r["nodeId"]))
    index = {int(r["nodeId"]): i for i, r in enumerate(nodes)}
    k = len(nodes)
    tree = {
        "feature": np.zeros(k, dtype=np.int64),
        "threshold": np.full(k, np.inf, dtype=np.float64),
        "left": np.arange(k, dtype=np.int64),
        "right": np.arange(k, dtype=np.int64),
        "leaf": np.ones(k, dtype=bool),
        "predict": np.zeros(k, dtype=np.float64),
    }
    for i, r in enumerate(nodes):
        tree["predict"][i] = float(r["predict"]["predict"])
        if bool(r["isLeaf"]):
            continue
        split = r["split"]
        if split is None:
            raise ValueError(
                f"internal node {r['nodeId']} has no split record"
            )
        if int(split["featureType"]) != 0:
            raise NotImplementedError(
                "categorical MLlib splits are not supported (the "
                "reference's 48 DWT features are all continuous)"
            )
        tree["leaf"][i] = False
        tree["feature"][i] = int(split["feature"])
        tree["threshold"][i] = float(split["threshold"])
        tree["left"][i] = index[int(r["leftNodeId"])]
        tree["right"][i] = index[int(r["rightNodeId"])]
    return tree


def _normalize_combining(raw: str) -> str:
    c = raw.strip().lower()
    if c in ("vote", "majority"):
        return "vote"
    if c == "sum":
        return "sum"
    if c in ("average", "avg"):
        return "average"
    raise ValueError(f"unknown combining strategy {raw!r}")


def read_tree_ensemble(path: str) -> MLlibTreeEnsemble:
    """Load a DecisionTreeModel / RandomForestModel /
    GradientBoostedTreesModel directory (the save targets at
    DecisionTreeClassifier.java:156-157 and the RF/GBT analogues)."""
    path, cleanup = _ensure_local(path)
    try:
        return _read_tree_ensemble_local(path)
    finally:
        cleanup()


def _read_tree_ensemble_local(path: str) -> MLlibTreeEnsemble:
    meta = read_metadata(path)
    cls = meta.get("class", "")
    if cls == TREE_DT:
        algo = meta.get("algo", "Classification")
        tree_weights = np.ones(1, dtype=np.float64)
        combining = "vote"
    elif cls in (TREE_RF, TREE_GBT):
        inner = meta.get("metadata", {})
        algo = inner.get("algo", "Classification")
        tree_weights = np.asarray(
            inner.get("treeWeights", []), dtype=np.float64
        )
        combining = _normalize_combining(
            inner.get(
                "combiningStrategy",
                "sum" if cls == TREE_GBT else "vote",
            )
        )
    else:
        raise ValueError(f"not an MLlib tree model dir: {cls!r}")

    by_tree: Dict[int, List[dict]] = {}
    for row in _read_data_rows(path):
        by_tree.setdefault(int(row.get("treeId", 0)), []).append(row)
    trees = [_nodes_to_tree(by_tree[t]) for t in sorted(by_tree)]
    if combining == "vote":
        # the vote path (and every consumer in models/trees.py) is
        # binary — same refuse-don't-guess policy as categorical
        # splits: a multiclass model's labels would be silently
        # collapsed by the >0.5 vote threshold
        for t in trees:
            labels = np.unique(t["predict"][t["leaf"]])
            if not np.isin(labels, (0.0, 1.0)).all():
                raise NotImplementedError(
                    f"multiclass MLlib tree model (leaf labels "
                    f"{labels.tolist()}) is not supported; the "
                    f"reference pipeline is binary (target vs "
                    f"non-target)"
                )
    if tree_weights.shape[0] == 0:
        tree_weights = np.ones(len(trees), dtype=np.float64)
    if tree_weights.shape[0] != len(trees):
        raise ValueError(
            f"treeWeights has {tree_weights.shape[0]} entries for "
            f"{len(trees)} trees"
        )
    return MLlibTreeEnsemble(
        model_class=cls,
        algo=algo,
        trees=trees,
        tree_weights=tree_weights,
        combining=combining,
    )


def write_tree_ensemble(
    path: str,
    model_class: str,
    trees: Sequence[Dict[str, np.ndarray]],
    tree_weights: Optional[Sequence[float]] = None,
    algo: str = "Classification",
    combining: Optional[str] = None,
) -> None:
    """Write a format-1.0 tree model directory from the compact array
    form (:class:`MLlibTreeEnsemble` layout). NodeIds use MLlib's
    heap convention (root 1, children ``2n``/``2n+1``-free explicit
    links are what the reader consumes, so any injective id works;
    the writer emits depth-first ids starting at 1). ``path`` may be
    a remote URI (built locally, then uploaded through
    io/modelfiles)."""
    materialize_model_dir(
        path,
        lambda local: _write_tree_ensemble_local(
            local, model_class, trees, tree_weights, algo, combining
        ),
    )


def _write_tree_ensemble_local(
    path: str,
    model_class: str,
    trees: Sequence[Dict[str, np.ndarray]],
    tree_weights: Optional[Sequence[float]],
    algo: str,
    combining: Optional[str],
) -> None:
    pq = _pq()  # first: without pyarrow, its message
    import pyarrow as pa
    if tree_weights is None:
        tree_weights = [1.0] * len(trees)

    # DFS-reachable node order per tree, computed up front: the
    # emitted rows AND the metadata numNodes must agree. Device-grown
    # heaps carry unreachable padded slots (trees_device
    # .heap_to_host_arrays fixed-size arrays), and Spark 1.6's
    # DecisionTreeModel.load asserts reconstructed count ==
    # metadata numNodes — counting array length would make the
    # exported directory unloadable there.
    orders: List[List[int]] = []
    for tree in trees:
        order: List[int] = []
        stack = [0]
        while stack:
            i = stack.pop()
            order.append(i)
            if not tree["leaf"][i]:
                stack.append(int(tree["right"][i]))
                stack.append(int(tree["left"][i]))
        orders.append(order)

    if model_class == TREE_DT:
        if len(trees) != 1:
            raise ValueError("DecisionTreeModel holds exactly one tree")
        meta = {
            "class": model_class,
            "version": _FORMAT_VERSION,
            "algo": algo,
            "numNodes": len(orders[0]),
        }
    elif model_class in (TREE_RF, TREE_GBT):
        meta = {
            "class": model_class,
            "version": _FORMAT_VERSION,
            "metadata": {
                "algo": algo,
                "treeAlgo": (
                    "Regression" if model_class == TREE_GBT else algo
                ),
                "combiningStrategy": (
                    combining
                    or ("Sum" if model_class == TREE_GBT else "Vote")
                ),
                "treeWeights": [float(w) for w in tree_weights],
            },
        }
    else:
        raise ValueError(f"unknown tree model class {model_class!r}")
    _write_metadata(path, meta)

    rows: List[dict] = []
    for tid, tree in enumerate(trees):
        # depth-first renumbering from 1 (ids are explicit links, any
        # injective assignment round-trips)
        order = orders[tid]
        ids = {i: k + 1 for k, i in enumerate(order)}
        for i in order:
            leaf = bool(tree["leaf"][i])
            rows.append(
                {
                    "treeId": tid,
                    "nodeId": ids[i],
                    "predict": {
                        "predict": float(tree["predict"][i]),
                        "prob": 0.0,
                    },
                    "impurity": 0.0,
                    "isLeaf": leaf,
                    "split": (
                        None
                        if leaf
                        else {
                            "feature": int(tree["feature"][i]),
                            "threshold": float(tree["threshold"][i]),
                            "featureType": 0,
                            "categories": [],
                        }
                    ),
                    "leftNodeId": (
                        None if leaf else ids[int(tree["left"][i])]
                    ),
                    "rightNodeId": (
                        None if leaf else ids[int(tree["right"][i])]
                    ),
                    "infoGain": None if leaf else 0.0,
                }
            )
    predict_t = pa.struct(
        [("predict", pa.float64()), ("prob", pa.float64())]
    )
    split_t = pa.struct(
        [
            ("feature", pa.int32()),
            ("threshold", pa.float64()),
            ("featureType", pa.int32()),
            ("categories", pa.list_(pa.float64())),
        ]
    )
    schema = pa.schema(
        [
            ("treeId", pa.int32()),
            ("nodeId", pa.int32()),
            ("predict", predict_t),
            ("impurity", pa.float64()),
            ("isLeaf", pa.bool_()),
            ("split", split_t),
            ("leftNodeId", pa.int32()),
            ("rightNodeId", pa.int32()),
            ("infoGain", pa.float64()),
        ]
    )
    _write_data(pq, pa.Table.from_pylist(rows, schema=schema), path)


# ------------------------------------------------------------ helpers


def materialize_model_dir(path: str, build_fn) -> None:
    """Run ``build_fn(local_dir)`` and land the resulting model
    directory at ``path`` — directly for local paths, or by building
    in a temp dir and uploading every file through the pluggable
    filesystem for remote URIs (``hdfs://``/``gs://``/``http(s)://``
    — the reference's models-on-HDFS flow,
    LogisticRegressionClassifier.java:144-152 saving to the
    Const.java namenode). Without this, a remote ``save_name`` would
    become a relative local directory."""
    import shutil
    import tempfile

    from . import modelfiles

    if modelfiles._is_local(path):
        build_fn(strip_file_prefix(path))
        return
    tmp = tempfile.mkdtemp(prefix="mllib_export_")
    try:
        build_fn(tmp)
        # clear any previous export first (the remote analogue of
        # delete_local_dir_target): a surviving old data part file
        # would be concatenated with the new one by every reader —
        # ours and Spark's. Filesystems without
        # delete can still LIST: deterministic part naming overwrites
        # our own previous export, but a directory Spark itself wrote
        # uses uuid-suffixed parts (part-r-00000-<uuid>.gz.parquet)
        # that no overwrite reaches — refuse rather than silently
        # coexist with them.
        fs = modelfiles._fs_for(path)
        if hasattr(fs, "delete_dir"):
            fs.delete_dir(path.rstrip("/"))
        elif hasattr(fs, "list_dir"):
            _check_no_stale_parts(fs, path.rstrip("/"), tmp)
        for root, _dirs, files in os.walk(tmp):
            rel_root = os.path.relpath(root, tmp)
            for name in files:
                rel = (
                    name
                    if rel_root == "."
                    else f"{rel_root}/{name}"
                )
                with open(os.path.join(root, name), "rb") as f:
                    modelfiles.write_model_bytes(
                        path.rstrip("/") + "/" + rel, f.read()
                    )
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _check_no_stale_parts(fs, path: str, tmp: str) -> None:
    """For a listing-capable filesystem WITHOUT recursive delete:
    refuse to upload over part files the upcoming writes won't
    overwrite. Every model-dir reader (ours and Spark's) concatenates
    all ``part-*`` files in ``data/``, so a uuid-suffixed leftover
    from a Spark-written directory would merge with the new export
    into a corrupt model. Missing target dirs are fine (fresh
    export); only per-subdir mismatched part files raise."""
    for sub in ("data", "metadata"):
        local_sub = os.path.join(tmp, sub)
        if not os.path.isdir(local_sub):
            continue
        new_names = set(os.listdir(local_sub))
        try:
            existing = fs.list_dir(f"{path}/{sub}")
        except (FileNotFoundError, OSError):
            continue
        stale = [
            name
            for name in existing
            if name.startswith("part-") and name not in new_names
        ]
        if stale:
            raise IOError(
                f"refusing to export model dir over {path}/{sub}: "
                f"existing part files {sorted(stale)} would not be "
                f"overwritten (uuid-suffixed Spark output?) and every "
                f"reader would concatenate them with the new rows — "
                f"delete the directory first"
            )


def _write_metadata(path: str, meta: dict) -> None:
    meta_dir = os.path.join(path, "metadata")
    os.makedirs(meta_dir, exist_ok=True)
    with open(
        os.path.join(meta_dir, "part-00000"), "w", encoding="utf-8"
    ) as f:
        f.write(json.dumps(meta, separators=(",", ":")) + "\n")
    open(os.path.join(meta_dir, "_SUCCESS"), "w").close()


def _write_data(pq, table, path: str, spark_schema: dict = None) -> None:
    data_dir = os.path.join(path, "data")
    os.makedirs(data_dir, exist_ok=True)
    if spark_schema is not None:
        # Spark SQL reads its row schema (UDT tags included) from this
        # footer key in preference to the parquet schema; pyarrow's
        # own tables carry no footer metadata from from_pylist, so
        # replace rather than merge
        table = table.replace_schema_metadata(
            {
                "org.apache.spark.sql.parquet.row.metadata": json.dumps(
                    spark_schema, separators=(",", ":")
                )
            }
        )
    # Spark-style part naming + gzip default codec
    # (spark.sql.parquet.compression.codec). DETERMINISTIC name, no
    # uuid: a re-export to the same remote directory must overwrite
    # the previous part file, not accumulate a second one the reader
    # (ours or Spark's) would concatenate into a corrupt model.
    name = "part-r-00000.gz.parquet"
    pq.write_table(
        table,
        os.path.join(data_dir, name),
        compression="gzip",
        # parquet format 1.0: Spark 1.6 bundles parquet-mr 1.7, which
        # predates the v2 file metadata; every type in these schemas
        # (double/int/bool/struct/list) is expressible in 1.0, so the
        # floor costs nothing and maximizes JVM-side readability
        version="1.0",
    )
    open(os.path.join(data_dir, "_SUCCESS"), "w").close()
