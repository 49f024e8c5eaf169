"""The port's MLlib model directories (``io/mllib_format.py`` and the
classifiers' ``config_model_format=mllib`` / ``load_name=<dir>``)
against the JAX package's.

- A directory written by either package reads in the other to equal
  weights, intercept, threshold and tree nodes, with equal predictions,
  and ``metadata/part-00000`` byte-equal; over ``hdfs://`` too (the
  loopback WebHDFS namenode of ``tests/_loopback.py``).
- ``load_name=<dir>`` batch runs of logreg, svm, dt, rf and gbt, each
  package's directory loaded by each package: ``result_path`` text
  byte-equal; ``serve=true`` on the imported float64 logreg equals its
  batch run.
- Every refusal raises the JAX package's exception and message, the
  missing-``pyarrow`` one included.

Needs ``pyarrow`` (the parquet data files); skipped without it.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("pyarrow")

from eeg_dataanalysispackage_tpu.io import mllib_format as jax_mf  # noqa: E402
from eeg_dataanalysispackage_tpu.io import remote as jax_remote  # noqa: E402
from eeg_dataanalysispackage_tpu.models import registry as jax_registry  # noqa: E402
from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder  # noqa: E402
from eeg_dataanalysispackage_tpu_torch.io import circuit  # noqa: E402
from eeg_dataanalysispackage_tpu_torch.io import mllib_format as mf  # noqa: E402
from eeg_dataanalysispackage_tpu_torch.models import registry  # noqa: E402
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _loopback  # noqa: E402
import _synthetic  # noqa: E402

#: small configurations of every family (each applies all its keys)
CONFIGS = {
    "logreg": "config_num_iterations=30&config_step_size=1.0&config_mini_batch_fraction=1.0",
    "svm": ("config_num_iterations=30&config_step_size=1.0&config_mini_batch_fraction=1.0"
            "&config_reg_param=0.01"),
    "dt": ("config_max_bins=16&config_impurity=gini&config_max_depth=3"
           "&config_min_instances_per_node=1"),
    "rf": ("config_max_bins=16&config_impurity=gini&config_max_depth=3"
           "&config_min_instances_per_node=1&config_num_trees=5&config_feature_subset=sqrt"),
    "gbt": "config_num_iterations=5&config_learning_rate=0.1&config_max_depth=2",
}
FAMILIES = tuple(CONFIGS)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(3)
    x = rng.randn(80, 6)
    y = ((x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.randn(80)) > 0).astype(np.float64)
    return x, y


def _fitted(name, x, y):
    """The port's and the JAX package's classifier of ``name`` fitted on
    ``x``, ``y`` with its small configuration."""
    config = dict(kv.split("=") for kv in CONFIGS[name].split("&"))
    ours, theirs = registry.create(name), jax_registry.create(name)
    ours.set_config(dict(config))
    theirs.set_config(dict(config))
    xf = x.astype(np.float32) if name in ("logreg", "svm") else x
    ours.fit(t(xf), t(y.astype(np.float32) if name in ("logreg", "svm") else y))
    theirs.fit(xf, y)
    return ours, theirs


def _same_model(a, b):
    """Two read directories (GLMModel or MLlibTreeEnsemble) hold the same
    model."""
    assert type(a).__name__ == type(b).__name__ and a.model_class == b.model_class
    if hasattr(a, "weights"):
        np.testing.assert_array_equal(a.weights, b.weights)
        assert (a.intercept, a.threshold, a.num_features, a.num_classes) == (
            b.intercept, b.threshold, b.num_features, b.num_classes)
        return
    assert (a.algo, a.combining) == (b.algo, b.combining)
    np.testing.assert_array_equal(a.tree_weights, b.tree_weights)
    assert len(a.trees) == len(b.trees)
    for ta, tb in zip(a.trees, b.trees):
        assert sorted(ta) == sorted(tb)
        for k in ta:
            np.testing.assert_array_equal(ta[k], tb[k])


def _read(module, path):
    meta = module.read_metadata(path)
    if meta["class"] in (mf.GLM_LOGREG, mf.GLM_SVM):
        return module.read_glm(path)
    return module.read_tree_ensemble(path)


@pytest.mark.parametrize("name", FAMILIES)
def test_directories_interchange_with_jax(data, tmp_path, name):
    """Each package exports its fitted model; each directory reads in
    both packages to the same model, the two exports' metadata are
    byte-equal, and every loaded classifier predicts alike."""
    x, y = data
    ours, theirs = _fitted(name, x, y)
    mine, other = str(tmp_path / "port"), str(tmp_path / "jax")
    ours.export_mllib_dir(mine)
    theirs.export_mllib_dir(other)
    with open(os.path.join(mine, "metadata", "part-00000"), "rb") as f:
        meta = f.read()
    with open(os.path.join(other, "metadata", "part-00000"), "rb") as f:
        assert f.read() == meta
    for path in (mine, other):
        _same_model(_read(mf, path), _read(jax_mf, path))
    if name in ("logreg", "svm"):
        # the two packages' SGD agree to float32 roundoff (tests/test_torch_sgd.py)
        np.testing.assert_allclose(_read(mf, mine).weights, _read(mf, other).weights,
                                   rtol=1e-5, atol=1e-6)
    else:
        _same_model(_read(mf, mine), _read(mf, other))  # the growers agree exactly
    xf = x.astype(np.float32)
    for path in (mine, other):
        loaded, jax_loaded = registry.create(name), jax_registry.create(name)
        loaded.load(path)
        jax_loaded.load(path)
        got = loaded.predict(t(xf)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_loaded.predict(xf)))
        if path == other and name != "gbt":
            # the export predicts as the model it came from (gbt's F == 0
            # boundary differs from MLlib's Sum, > 0)
            np.testing.assert_array_equal(got, np.asarray(theirs.predict(xf)))
    if name in ("logreg", "svm"):
        assert loaded.model.weight.dtype == torch.float64
        m = loaded.margin(t(xf)).numpy()
        want_m = xf.astype(np.float64) @ jax_loaded.weights + jax_loaded.intercept
        assert np.array_equal(m, want_m)


@pytest.mark.parametrize("name", ["logreg", "rf"])
def test_reexport_of_an_imported_model_is_unchanged(data, tmp_path, name):
    """An imported directory re-exports as it is (``export_mllib_dir`` and
    ``save`` with ``config_model_format=mllib``), as the JAX package's."""
    x, y = data
    _, theirs = _fitted(name, x, y)
    src = str(tmp_path / "src")
    theirs.export_mllib_dir(src)
    clf = registry.create(name)
    clf.load(src)
    clf.set_config({"config_model_format": "mllib"})
    clf.save(str(tmp_path / "again"))
    _same_model(_read(mf, src), _read(mf, str(tmp_path / "again")))


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    return _synthetic.write_session(str(tmp_path_factory.mktemp("mllib_session")),
                                    n_markers=60)


@pytest.mark.parametrize("name", FAMILIES)
def test_load_name_dir_result_path_equals_jax(session, tmp_path, name):
    """``save_clf=true&config_model_format=mllib`` by each package, then
    ``load_clf=<name>&load_name=<dir>`` of both directories by both
    packages: every ``result_path`` text is byte-equal to the JAX
    package's load of the same directory. The host ``fe=dwt-8`` path:
    its float64 features are the JAX package's bit for bit, so a test
    row that is a training row, sitting on a tree's split threshold,
    falls on the same side in both."""
    base = f"info_file={session}&fe=dwt-8&cache=false"
    dirs = {}
    for who, builder in (("port", PipelineBuilder), ("jax", JaxBuilder)):
        d = str(tmp_path / f"{who}_model")
        q = (f"{base}&train_clf={name}&{CONFIGS[name]}&config_model_format=mllib"
             f"&save_clf=true&save_name={d}")
        (builder(q, device="cpu") if who == "port" else builder(q)).execute()
        assert mf.is_model_dir(d)
        dirs[who] = d
    for who, d in dirs.items():
        texts = {}
        for runner in ("port", "jax"):
            out = tmp_path / f"{who}_{runner}.txt"
            q = f"{base}&load_clf={name}&load_name={d}&result_path={out}"
            (PipelineBuilder(q, device="cpu") if runner == "port" else JaxBuilder(q)).execute()
            texts[runner] = out.read_text()
        assert texts["port"] == texts["jax"], (name, who)


def test_serve_true_on_an_imported_model_equals_its_batch_run(session, tmp_path):
    """An imported (float64) logreg is served in the featurize+host mode:
    the served statistics equal the batch ``load_name=<dir>`` run's."""
    d = str(tmp_path / "glm")
    rng = np.random.RandomState(5)
    jax_mf.write_glm(d, jax_mf.GLM_LOGREG, rng.randn(48), intercept=0.1, threshold=0.5)
    q = f"info_file={session}&fe=dwt-8-fused&load_clf=logreg&load_name={d}&cache=false"
    batch = PipelineBuilder(q, device="cpu")
    want = str(batch.execute())
    assert want == str(JaxBuilder(q).execute())
    served = PipelineBuilder(q + "&serve=true", device="cpu")
    assert str(served.execute()) == want
    assert served.serve_block["requests"]["completed"] == len(batch.targets)


def test_hdfs_model_directories_interchange(tmp_path, monkeypatch):
    """A model directory saved to ``hdfs://`` by either package (uploaded
    file by file, a previous export deleted first) loads in the other
    from there."""
    for var in ("WEBHDFS_ENDPOINT", "WEBHDFS_USER", "HDFS_DRIVER"):
        monkeypatch.delenv(var, raising=False)
    rng = np.random.RandomState(9)
    w = rng.randn(12)
    x = rng.randn(20, 12).astype(np.float32)
    with _loopback.Server() as srv:
        circuit.reset()
        jax_remote.circuit.reset()
        try:
            for write, read in ((mf, jax_registry), (jax_mf, registry)):
                srv.reset()
                uri = f"hdfs://{srv.authority}/models/logreg"
                write.write_glm(uri, write.GLM_LOGREG, w, intercept=-0.2, threshold=0.4)
                assert mf.is_model_dir(uri) and jax_mf.is_model_dir(uri)
                clf = read.create("logreg")
                clf.load(uri)
                got = clf.predict(t(x) if read is registry else x)
                want = (x.astype(np.float64) @ w - 0.2 > np.log(0.4 / 0.6)).astype(np.float64)
                np.testing.assert_array_equal(np.asarray(got), want)
        finally:
            circuit.reset()
            jax_remote.circuit.reset()


# -- the refusals -----------------------------------------------------------------------


def _manual_tree():
    """Root on feature 3 @ 0.0; left leaf 0; right splits feature 1 @ 1.0
    into 1 / 0."""
    return {
        "feature": np.array([3, 0, 1, 0, 0]),
        "threshold": np.array([0.0, np.inf, 1.0, np.inf, np.inf]),
        "left": np.array([1, 1, 3, 3, 4]),
        "right": np.array([2, 1, 4, 3, 4]),
        "leaf": np.array([False, True, False, True, True]),
        "predict": np.array([0.0, 0.0, 0.0, 1.0, 0.0]),
    }


def _rewrite_rows(path, edit):
    import pyarrow as pa
    import pyarrow.parquet as pq

    data_dir = os.path.join(path, "data")
    f = [os.path.join(data_dir, p) for p in os.listdir(data_dir) if p.endswith(".parquet")][0]
    table = pq.read_table(f)
    rows = table.to_pylist()
    rows = edit(rows) or rows
    pq.write_table(pa.Table.from_pylist(rows, schema=table.schema), f)


def _case_glm_class(m, d):
    m.write_glm(d, m.GLM_SVM, np.ones(4))
    return lambda pkg: pkg.create("logreg").load(d)


def _case_multinomial(m, d):
    m.write_glm(d, m.GLM_LOGREG, np.ones(8), num_classes=3)
    return lambda pkg: pkg.create("logreg").load(d)


def _case_cleared_threshold(m, d):
    m.write_glm(d, m.GLM_LOGREG, np.ones(4), threshold=None)
    return lambda pkg: pkg.create("logreg").load(d)


def _case_tree_class(m, d):
    m.write_tree_ensemble(d, m.TREE_RF, [_manual_tree()])
    return lambda pkg: pkg.create("dt").load(d)


def _case_categorical(m, d):
    m.write_tree_ensemble(d, m.TREE_DT, [_manual_tree()])

    def edit(rows):
        for r in rows:
            if r["split"] is not None:
                r["split"]["featureType"] = 1
    _rewrite_rows(d, edit)
    return lambda pkg: pkg.create("dt").load(d)


def _case_multiclass_tree(m, d):
    tree = _manual_tree()
    tree["predict"] = np.array([0.0, 2.0, 0.0, 1.0, 0.0])
    m.write_tree_ensemble(d, m.TREE_DT, [tree])
    return lambda pkg: pkg.create("dt").load(d)


def _case_no_split(m, d):
    m.write_tree_ensemble(d, m.TREE_DT, [_manual_tree()])

    def edit(rows):
        for r in rows:
            r["split"] = None
    _rewrite_rows(d, edit)
    return lambda pkg: pkg.create("dt").load(d)


def _case_single_row(m, d):
    m.write_glm(d, m.GLM_LOGREG, np.ones(4))
    _rewrite_rows(d, lambda rows: rows + rows)
    return lambda pkg: pkg.create("logreg").load(d)


def _case_tree_weights(m, d):
    m.write_tree_ensemble(d, m.TREE_RF, [_manual_tree()], tree_weights=[1.0])
    meta = m.read_metadata(d)
    meta["metadata"]["treeWeights"] = [1.0, 2.0]
    with open(os.path.join(d, "metadata", "part-00000"), "w") as fh:
        fh.write(json.dumps(meta))
    return lambda pkg: pkg.create("rf").load(d)


def _case_blank_metadata(m, d):
    os.makedirs(os.path.join(d, "metadata"))
    with open(os.path.join(d, "metadata", "part-00000"), "w") as fh:
        fh.write("\n\n")
    return lambda pkg: pkg.create("svm").load(d)


def _case_one_dt(m, d):
    return lambda pkg: _module(pkg).write_tree_ensemble(
        d, _module(pkg).TREE_DT, [_manual_tree()] * 2)


def _case_remote_without_listing(m, d):
    return lambda pkg: _module(pkg).read_glm("http://127.0.0.1:9/models/m")


def _module(pkg):
    return mf if pkg is registry else jax_mf


@pytest.mark.parametrize("case", [
    _case_glm_class, _case_multinomial, _case_cleared_threshold, _case_tree_class,
    _case_categorical, _case_multiclass_tree, _case_no_split, _case_single_row,
    _case_tree_weights, _case_blank_metadata, _case_one_dt, _case_remote_without_listing,
], ids=lambda f: f.__name__[len("_case_"):])
def test_refusals_equal_jax(tmp_path, case):
    """Each refusal raises the JAX package's exception type and message
    in the port (the directory written by the JAX package's writer, and
    again by the port's)."""
    outcomes = []
    for writer in (jax_mf, mf):
        d = str(tmp_path / writer.__name__.split(".")[0])
        op = case(writer, d)
        got = []
        for pkg in (registry, jax_registry):
            with pytest.raises(Exception) as info:
                op(pkg)
            got.append((type(info.value).__name__, str(info.value)))
        assert got[0] == got[1], got
        outcomes.append(got[0][0])
    assert outcomes[0] == outcomes[1]


def test_missing_pyarrow_raises_the_jax_message(monkeypatch, tmp_path):
    """Without ``pyarrow`` (the card's host has none) the package still
    imports; writing or reading a directory raises the JAX package's
    ``ImportError`` message, and a npz model is untouched by it."""
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    msgs = []
    for m in (mf, jax_mf):
        with pytest.raises(ImportError) as info:
            m._pq()
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] and "pyarrow" in msgs[0]
    clf = registry.create("logreg")
    clf.set_config({"config_model_format": "mllib"})
    clf.fit(t(np.eye(4, dtype=np.float32)), t(np.array([0, 1, 0, 1], np.float32)))
    with pytest.raises(ImportError) as info:
        clf.save(str(tmp_path / "m"))
    assert str(info.value) == msgs[0]
    os.makedirs(tmp_path / "d" / "metadata")
    (tmp_path / "d" / "metadata" / "part-00000").write_text(
        json.dumps({"class": mf.GLM_LOGREG, "version": "1.0"}) + "\n")
    with pytest.raises(ImportError) as info:
        registry.create("logreg").load(str(tmp_path / "d"))
    assert str(info.value) == msgs[0]
    clf.set_config({})
    clf.save(str(tmp_path / "native"))
    registry.create("logreg").load(str(tmp_path / "native"))
