"""The port's tree classifiers (``models/trees.py``: ``dt``, ``rf``,
``gbt`` and their ``-tpu`` names) against the JAX package's, on the CPU.

- The split sketch, the bin edges and the binning: bit-equal on the JAX
  package's own cases (tests/test_mllib_tree_parity.py) and on
  float32-rounded features with ties.
- The host growers: tree arrays bit-equal (``dt`` over the 12 seeded
  trials of ``test_production_dt_bit_matches_oracle`` at gini and
  entropy, ``rf`` at every subset strategy, ``gbt``), predictions equal.
- Model files: the same members (the ``meta`` JSON text, ``edges``, each
  ``tree{i}_*`` array and its dtype; ``np.savez`` stamps the zip members
  with the wall time, so the bytes are not compared; ``gbt-tpu``'s trees
  under the boosting tolerance of tests/test_torch_trees_device.py),
  loaded by either package, predicting as the model that saved them.
- The pipeline: ``fe=dwt-8&train_clf=dt|rf|gbt`` (and their ``-tpu``
  names) report statistics byte-equal to the JAX package's; ``fe=dwt-8``
  hands the trees float64 rows. On ``fe=dwt-8-fused`` the two packages'
  feature rows differ by up to ~2e-7 (the plain featurizer's float32
  order), so a test row may be classified differently only where a
  feature compared on its path lies within ``EDGE_TOL`` = 2e-6 of that
  split's edge (``trees.edge_distance``); such rows are counted.
- Serving: ``serve=true&load_clf=rf`` (and the other names) equals the
  port's batch ``load_clf=`` run byte for byte, and the JAX package's
  served statistics under the same edge rule (the JAX package's served
  rows are its ``xla`` formulation's, not its batch rows, so its own
  served and batch statistics can differ by such rows).
"""

import os
import sys

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.io.provider import OfflineDataProvider as JaxProvider
from eeg_dataanalysispackage_tpu.models import mllib_tree_oracle as oracle
from eeg_dataanalysispackage_tpu.models import registry as jax_registry
from eeg_dataanalysispackage_tpu.models import trees as jax_trees
from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu.serve.multiplex import MultiplexedService as JaxMultiplexed
from eeg_dataanalysispackage_tpu_torch.models import registry, stats, trees
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
from eeg_dataanalysispackage_tpu_torch.serve import MultiplexedService
from eeg_dataanalysispackage_tpu_torch.utils import java_compat

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402
from test_torch_trees_device import check_boost  # noqa: E402

EDGE_TOL = 2e-6
NAMES = ("dt", "rf", "gbt", "dt-tpu", "rf-tpu", "gbt-tpu")
#: small configurations that keep the pipeline runs fast
SMALL = {
    "dt": "",
    "rf": ("&config_max_bins=16&config_impurity=gini&config_max_depth=4"
           "&config_min_instances_per_node=1&config_num_trees=10&config_feature_subset=sqrt"),
    "gbt": "&config_num_iterations=10&config_learning_rate=0.1&config_max_depth=3",
}
SMALL.update({f"{k}-tpu": v for k, v in list(SMALL.items())})


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_same_trees(ours, theirs):
    assert len(ours.trees) == len(theirs.trees) > 0
    for a, b in zip(ours.trees, theirs.trees):
        assert list(a) == list(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ours.edges.dtype == theirs.edges.dtype
    np.testing.assert_array_equal(ours.edges, theirs.edges)


# -- the split sketch and the binning -------------------------------------------------


@pytest.mark.parametrize("samples,num_splits", [
    ([1.0, 1.0, 2.0, 2.0, 3.0], 6),
    ([10.0, 10.0, 20.0, 20.0, 30.0, 30.0, 40.0, 40.0], 2),
    ([5.0] * 90 + [6.0] * 5 + [7.0] * 5, 3),
    ([5.0] * 90 + [6.0] * 5 + [7.0] * 5, 2),
])
def test_split_sketch_equals_the_oracle_on_its_cases(samples, num_splits):
    got = trees.find_splits_for_continuous_feature(np.array(samples), num_splits)
    want = oracle.find_splits_for_continuous_feature(np.array(samples), num_splits)
    assert got.dtype == want.dtype and got.tolist() == want.tolist()


@pytest.mark.parametrize("n,d,max_bins,scale", [(7, 3, 32, None), (120, 8, 32, 4.0),
                                                (400, 20, 16, 50.0), (1494, 48, 32, None)])
def test_bin_edges_and_bins_equal_on_float32_rows_with_ties(n, d, max_bins, scale):
    rng = np.random.RandomState(n)
    x = rng.randn(n, d)
    if scale is not None:
        x = np.round(x * scale) / scale  # few distinct values: ties
    x = x.astype(np.float32).astype(np.float64)
    edges = trees.compute_bin_edges(x, max_bins)
    want = jax_trees.compute_bin_edges(x, max_bins)
    assert edges.dtype == want.dtype and edges.shape == (d, max_bins - 1)
    np.testing.assert_array_equal(edges, want)
    binned = trees.bin_features(x, edges)
    assert binned.dtype == np.int32
    np.testing.assert_array_equal(binned, jax_trees.bin_features(x, want))
    # a value equal to an edge goes left
    X = np.array([[0.5], [1.0], [1.5], [2.0], [2.5]])
    assert trees.bin_features(X, np.array([[1.0, 2.0]]))[:, 0].tolist() == [0, 0, 1, 1, 2]


# -- the host growers -----------------------------------------------------------------


def oracle_trial(trial):
    """The inputs of test_mllib_tree_parity.py's 12 seeded trials."""
    rng = np.random.RandomState(100 + trial)
    n = int(rng.choice([7, 11, 40, 120]))
    d = int(rng.choice([3, 8, 20]))
    X = rng.randn(n, d)
    y = ((X[:, 0] + 0.3 * rng.randn(n)) > 0).astype(float)
    if y.sum() in (0, n):
        y[0] = 1 - y[0]
    mb = int(rng.choice([4, 8, 32]))
    md = int(rng.choice([2, 5, 8]))
    rng.choice(["gini", "entropy"])
    mi = int(rng.choice([1, 3]))
    return X, y, rng.randn(80, d), mb, md, mi


def fit_both(name, config, x, y):
    ours, theirs = registry.create(name), jax_registry.create(name)
    ours.set_config(config)
    theirs.set_config(config)
    ours.fit(t(x), t(y))
    theirs.fit(x, y)
    return ours, theirs


@pytest.mark.parametrize("impurity", ["gini", "entropy"])
@pytest.mark.parametrize("trial", range(12))
def test_host_dt_trees_bit_equal_over_the_oracle_trials(trial, impurity):
    X, y, Xt, mb, md, mi = oracle_trial(trial)
    config = {"config_max_bins": str(mb), "config_impurity": impurity,
              "config_max_depth": str(md), "config_min_instances_per_node": str(mi)}
    ours, theirs = fit_both("dt", config, X, y)
    assert_same_trees(ours, theirs)
    for rows in (X, Xt):
        got = ours.predict(t(rows))
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), theirs.predict(rows))


@pytest.mark.parametrize("subset", ["auto", "all", "sqrt", "log2", "onethird"])
def test_host_rf_trees_bit_equal_at_every_subset_strategy(subset):
    rng = np.random.RandomState(5)
    x = rng.randn(150, 10)
    y = ((x[:, 0] - x[:, 3] + 0.5 * rng.randn(150)) > 0).astype(float)
    config = {"config_max_bins": "16", "config_impurity": "entropy", "config_max_depth": "4",
              "config_min_instances_per_node": "1", "config_num_trees": "7",
              "config_feature_subset": subset}
    ours, theirs = fit_both("rf", config, x, y)
    assert_same_trees(ours, theirs)
    np.testing.assert_array_equal(ours.predict(t(x)).numpy(), theirs.predict(x))


def test_rf_defaults_and_unknown_subset_strategy():
    ours, theirs = registry.create("rf"), jax_registry.create("rf")
    assert ours._n_trees() == theirs._n_trees() == 100
    assert ours._feature_subset(48) == theirs._feature_subset(48) == 7  # auto -> sqrt
    config = {**{k: "1" for k in trees.RandomForestClassifier.required_keys},
              "config_feature_subset": "half"}
    for clf in (ours, theirs):
        clf.set_config(config)
        with pytest.raises(ValueError, match="unsupported feature subset strategy: half"):
            clf._feature_subset(48)


@pytest.mark.parametrize("config", [
    {}, {"config_num_iterations": "12", "config_learning_rate": "0.3", "config_max_depth": "2"},
])
def test_host_gbt_trees_bit_equal(config):
    rng = np.random.RandomState(8)
    x = rng.randn(200, 12)
    y = ((x[:, 0] + x[:, 1] ** 2 - 1 + 0.3 * rng.randn(200)) > 0).astype(float)
    ours, theirs = fit_both("gbt", config, x, y)
    assert_same_trees(ours, theirs)
    assert ours._params == theirs._params
    np.testing.assert_array_equal(ours.predict(t(x)).numpy(), theirs.predict(x))


@pytest.mark.parametrize("name", ["dt-tpu", "rf-tpu"])
def test_device_backend_classifiers_equal_jax(name):
    rng = np.random.RandomState(11)
    x = rng.randn(300, 8).astype(np.float32).astype(np.float64)
    y = ((x[:, 0] + 0.5 * x[:, 2] + 0.3 * rng.randn(300)) > 0).astype(float)
    config = {"config_max_bins": "16", "config_impurity": "gini", "config_max_depth": "4",
              "config_min_instances_per_node": "1", "config_num_trees": "12",
              "config_feature_subset": "onethird"}
    ours, theirs = fit_both(name, config, x, y)
    assert_same_trees(ours, theirs)
    np.testing.assert_array_equal(ours.predict(t(x)).numpy(), theirs.predict(x))


def test_device_backend_refusals_match_jax():
    x = np.random.RandomState(0).randn(60, 4)
    y = (x[:, 0] > 0).astype(float)
    deep = {"config_max_bins": "8", "config_impurity": "gini", "config_max_depth": "13",
            "config_min_instances_per_node": "1"}
    for name, config in (("dt-tpu", deep), ("gbt-tpu", {
            "config_num_iterations": "2", "config_learning_rate": "0.1",
            "config_max_depth": "13"})):
        for clf, feats in ((registry.create(name), t(x)), (jax_registry.create(name), x)):
            clf.set_config(config)
            with pytest.raises(ValueError, match="max_depth <= 12.*backend='host'"):
                clf.fit(feats, y)
    for make in (trees.DecisionTreeClassifier, jax_trees.DecisionTreeClassifier):
        clf = make()
        clf.set_config({"config_backend": "tpu"})
        with pytest.raises(ValueError, match="unknown tree backend: 'tpu'"):
            clf.fit(t(x) if make is trees.DecisionTreeClassifier else x, y)
        with pytest.raises(ValueError, match="unknown tree backend: 'Device'"):
            make(backend="Device")
        with pytest.raises(ValueError, match="model not trained or loaded"):
            make().predict(t(x) if make is trees.DecisionTreeClassifier else x)


def test_config_backend_device_grows_the_heap_layout():
    x = np.random.RandomState(3).randn(200, 5)
    y = (x[:, 1] > 0.2).astype(float)
    config = {"config_max_bins": "8", "config_impurity": "gini", "config_max_depth": "3",
              "config_min_instances_per_node": "1", "config_backend": "device"}
    ours, theirs = fit_both("dt", config, x, y)
    assert_same_trees(ours, theirs)
    assert ours.trees[0]["left"][0] == 1  # the device grower's heap


# -- model files ----------------------------------------------------------------------


def npz_members(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("name", NAMES)
def test_model_files_have_equal_members_and_load_across_packages(name, tmp_path):
    rng = np.random.RandomState(2)
    x = rng.randn(160, 6)
    y = ((x[:, 0] + x[:, 3] + 0.4 * rng.randn(160)) > 0).astype(float)
    config = {"config_max_bins": "8", "config_impurity": "entropy", "config_max_depth": "3",
              "config_min_instances_per_node": "1", "config_num_trees": "5",
              "config_feature_subset": "sqrt", "config_num_iterations": "6",
              "config_learning_rate": "0.2"}
    ours, theirs = fit_both(name, config, x, y)
    ours.save(f"file://{tmp_path}/port")
    theirs.save(str(tmp_path / "jax"))
    a, b = npz_members(tmp_path / "port.npz"), npz_members(tmp_path / "jax.npz")
    assert list(a) == list(b)
    assert str(a["meta"]) == str(b["meta"])
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        if name != "gbt-tpu" or k in ("meta", "edges"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if name == "gbt-tpu":
        # float32 residual sums: every split flip explained and the leaves
        # within tolerance (tests/test_torch_trees_device.py)
        check_boost(trees.bin_features(x, ours.edges), y, rounds=6, learning_rate=0.2)
    saved = {"port": ours.predict(t(x)).numpy(), "jax": theirs.predict(x)}
    if name != "gbt-tpu":
        np.testing.assert_array_equal(saved["port"], saved["jax"])
    for path, want in saved.items():
        mine, other = registry.create(name), jax_registry.create(name)
        mine.load(str(tmp_path / path))
        other.load(str(tmp_path / path) + ".npz")
        np.testing.assert_array_equal(mine.predict(t(x)).numpy(), want)
        np.testing.assert_array_equal(other.predict(x), want)


def test_mllib_model_directories_are_refused(tmp_path):
    """MLlib model directories load and save (tests/test_torch_mllib_format.py);
    what is still refused is refused as the JAX package refuses it: a
    directory that is no model, an imported model's native save, another
    class's directory, another class's npz."""
    pytest.importorskip("pyarrow")
    clf, other = registry.create("rf"), jax_registry.create("rf")
    for c in (clf, other):
        with pytest.raises(FileNotFoundError):
            c.load(str(tmp_path))
    x = np.random.RandomState(0).randn(40, 3)
    y = (x[:, 0] > 0).astype(float)
    clf.set_config({"config_model_format": "mllib", "config_num_trees": "3",
                    **{k: v for k, v in zip(trees.DecisionTreeClassifier.required_keys,
                                            ("8", "gini", "3", "1"))},
                    "config_feature_subset": "all"})
    clf.fit(t(x), t(y))
    clf.save(str(tmp_path / "m"))
    assert not os.path.exists(tmp_path / "m.npz") and os.path.isdir(tmp_path / "m" / "metadata")
    errors = []
    for mine, theirs in ((registry.create("rf"), jax_registry.create("rf")),
                         (registry.create("gbt"), jax_registry.create("gbt"))):
        got = []
        for c in (mine, theirs):
            try:
                c.load(str(tmp_path / "m"))
                c.set_config({})
                c.save(str(tmp_path / "native"))
            except ValueError as e:
                got.append(str(e))
        assert got[0] == got[1] and got[0], got
        errors.append(got[0])
    assert errors[0] == ("this model was loaded from an MLlib model directory; re-export it "
                         "with export_mllib_dir(path)")
    assert "holds org.apache.spark.mllib.tree.model.RandomForestModel" in errors[1]
    with pytest.raises(ValueError, match="was saved by RandomForestClassifier, not Gradient"):
        clf.set_config({})
        clf.save(str(tmp_path / "n"))
        registry.create("gbt").load(str(tmp_path / "n"))


# -- the pipeline ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    return _synthetic.write_session(str(tmp_path_factory.mktemp("trees")), n_markers=400)


@pytest.mark.parametrize("name", NAMES)
def test_host_fe_pipeline_statistics_byte_equal(session, name, tmp_path):
    q = f"info_file={session}&fe=dwt-8&train_clf={name}{SMALL[name]}"
    ours = PipelineBuilder(q + f"&save_clf=true&save_name={tmp_path}/port", device="cpu")
    text = str(ours.execute())
    assert text == str(JaxBuilder(q + f"&save_clf=true&save_name={tmp_path}/jax").execute())
    for path in ("port", "jax"):
        load = f"info_file={session}&fe=dwt-8&load_clf={name}&load_name={tmp_path}/{path}"
        assert str(PipelineBuilder(load, device="cpu").execute()) == str(
            JaxBuilder(load).execute())


def test_host_fe_trees_receive_float64_rows(session, tmp_path, monkeypatch):
    """fe=dwt-8 hands fit the extractor's float64 rows (the JAX package's
    dtype), so the saved edges equal the JAX package's bit for bit; the
    linear family keeps its float32 cast."""
    seen = {}
    real = trees.DecisionTreeClassifier.fit

    def spy(self, features, labels):
        seen["dtype"] = features.dtype
        return real(self, features, labels)

    monkeypatch.setattr(trees.DecisionTreeClassifier, "fit", spy)
    q = f"info_file={session}&fe=dwt-8&train_clf=dt&save_clf=true"
    PipelineBuilder(q + f"&save_name={tmp_path}/port", device="cpu").execute()
    JaxBuilder(q + f"&save_name={tmp_path}/jax").execute()
    assert seen["dtype"] == torch.float64
    a, b = npz_members(tmp_path / "port.npz"), npz_members(tmp_path / "jax.npz")
    np.testing.assert_array_equal(a["edges"], b["edges"])
    # the float32 rows would have moved the sketch's thresholds
    batch = PipelineBuilder(f"info_file={session}&fe=dwt-8&train_clf=dt", device="cpu")
    batch.execute()
    rows = batch.fe.extract_batch(batch.batch.epochs).numpy()
    assert not np.array_equal(trees.compute_bin_edges(rows.astype(np.float32), 32),
                              trees.compute_bin_edges(rows, 32))
    assert registry.create("logreg").fit_dtype == torch.float32
    assert registry.create("nn").fit_dtype == torch.float32


def jax_fused_rows(session, backend="decode"):
    """The JAX package's fused feature rows: its batch run's (``decode``),
    or its serving engine's (the ``xla`` formulation's rows)."""
    feats, _ = JaxProvider([session]).load_features_device(backend=backend)
    return np.asarray(feats, dtype=np.float64)


def differing_rows_explained(ours_clf, ours_rows, theirs_clf, theirs_rows):
    """Rows the two classifiers label differently on their own feature
    rows; asserts each lies within EDGE_TOL of a split edge on its path in
    one of the two models, and returns how many there are."""
    a = ours_clf.predict(t(ours_rows)).numpy()
    b = np.asarray(theirs_clf.predict(theirs_rows))
    differ = a != b
    near = ((trees.edge_distance(ours_clf.trees, ours_clf.edges, ours_rows) <= EDGE_TOL)
            | (trees.edge_distance(theirs_clf.trees, theirs_clf.edges, theirs_rows) <= EDGE_TOL))
    assert near[differ].all(), np.nonzero(differ & ~near)
    return int(differ.sum())


@pytest.mark.parametrize("name", ["dt-tpu", "rf-tpu", "gbt-tpu"])
def test_fused_pipeline_under_the_edge_rule(session, name, tmp_path):
    q = f"info_file={session}&fe=dwt-8-fused&train_clf={name}{SMALL[name]}"
    ours = PipelineBuilder(q, device="cpu")
    ours_stats = ours.execute()
    theirs_stats = JaxBuilder(q + f"&save_clf=true&save_name={tmp_path}/jax").execute()
    theirs = jax_registry.create(name)
    theirs.load(str(tmp_path / "jax"))
    rows = np.asarray(ours.test_index, np.int64)
    flips = differing_rows_explained(ours.classifier, ours.features[rows].double().numpy(),
                                     theirs, jax_fused_rows(session)[rows])
    print(f"{name}: fused test rows classified differently (within {EDGE_TOL} of an edge): "
          f"{flips}")
    if flips == 0:
        assert str(ours_stats) == str(theirs_stats)


@pytest.mark.parametrize("name", NAMES)
def test_served_trees_equal_the_batch_run_and_the_jax_service(session, name, tmp_path):
    model = str(tmp_path / "model")
    fused = f"info_file={session}&fe=dwt-8-fused"
    PipelineBuilder(f"{fused}&train_clf={name}{SMALL[name]}&save_clf=true&save_name={model}",
                    device="cpu").execute()
    load = f"{fused}&load_clf={name}&load_name={model}"
    batch = PipelineBuilder(load, device="cpu")
    batch_stats = batch.execute()
    served = PipelineBuilder(load + f"&serve=true&result_path={tmp_path}/served.txt",
                             device="cpu")
    assert str(served.execute()) == str(batch_stats)
    block = served.serve_block
    assert (block["mode"], block["rung"], block["mega"]) == ("featurize+host", "fused", None)
    # the JAX package serves the same file from its serving engine's own
    # feature rows (which are not its batch rows): equal except rows
    # within EDGE_TOL of an edge on their path
    theirs = str(JaxBuilder(load + "&serve=true").execute())
    jax_clf = jax_registry.create(name)
    jax_clf.load(model)
    rows = np.asarray(batch.test_index, np.int64)
    jax_rows = jax_fused_rows(session, "xla")[rows]
    flips = differing_rows_explained(batch.classifier, batch.features[rows].double().numpy(),
                                     jax_clf, jax_rows)
    want = stats.ClassificationStatistics.from_arrays(
        np.asarray(jax_clf.predict(jax_rows)), np.asarray(batch.targets, np.float64)[rows],
        confusion_only=True)
    assert theirs == str(want)
    print(f"{name}: served rows classified differently from the JAX service "
          f"(within {EDGE_TOL} of an edge): {flips}")
    assert rows.tolist() == java_compat.java_shuffle_indices(len(batch.targets), seed=1)


def test_multiplexed_service_refuses_a_tree_as_jax_does(session, tmp_path):
    model = str(tmp_path / "rf")
    PipelineBuilder(f"info_file={session}&fe=dwt-8-fused&train_clf=rf{SMALL['rf']}"
                    f"&save_clf=true&save_name={model}", device="cpu").execute()
    ours, theirs = registry.create("rf"), jax_registry.create("rf")
    ours.load(model)
    theirs.load(model)
    with pytest.raises(ValueError) as a:
        MultiplexedService({"a": ours}, device="cpu")
    with pytest.raises(ValueError) as b:
        JaxMultiplexed({"a": theirs})
    assert str(a.value) == str(b.value)
    assert "not multiplexable" in str(a.value)
