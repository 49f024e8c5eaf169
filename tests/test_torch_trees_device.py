"""The port's device tree growers (``models/trees_device.py``, the ``-tpu``
names) against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX package's jitted growers
(the form its classifiers run) and the port's torch ones:

- ``draw_feature_masks``, ``_grow_one``, ``grow_forest`` (T = 20 in
  chunks of 8, and forests over heavily tied features at every subset
  size, both impurities), ``predict_forest``, ``predict_linked_forest``
  and its chunked form, ``host_trees_to_device`` and
  ``heap_to_host_arrays`` (on the JAX package's own arrays): bit-equal;
- XLA's float32 ``log`` and the impurities, emulated from IEEE
  operations: bit-equal to ``jax.jit``'s;
- constructed ties (duplicate columns, empty bins) resolve to the first
  (feature, bin), as ``jnp.argmax`` does;
- the regression grower on quantized residuals (exact sums): bit-equal;
- ``boost_gbt``: the regression histograms sum float32 residuals, whose
  order XLA does not let the port reproduce, so the tolerance is stated.
  At 15 rounds: the same splits, leaf values within ``LEAF_TOL`` of the
  JAX package's (measured 8.9e-8) and the predictions equal except on
  rows with ``|F| < F_NEAR``. At 100 rounds on 1,494 rows, every split
  the packages choose differently is counted and explained: the same
  partition of the node's rows, or two scores within ``GAP_TOL`` of each
  other when recomputed in float64 (measured: equal, rows of equal
  residual traded between the sides); the leaves before the first such
  near tie stay within ``LEAF_TOL``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.models import trees as jax_trees
from eeg_dataanalysispackage_tpu.models import trees_device as jax_td
from eeg_dataanalysispackage_tpu_torch.models import trees, trees_device as td

LEAF_TOL = 1e-6
F_NEAR = 1e-5
GAP_TOL = 1e-6


def toy(n=400, d=6, seed=0):
    """The JAX package's tests/test_trees_device.py inputs."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    y = ((x[:, 0] + 0.5 * x[:, 2] - 0.25 * x[:, 4]) > 0).astype(np.float64)
    flip = rng.rand(n) < 0.05
    y[flip] = 1 - y[flip]
    return x, y


def binned_toy(n=400, d=6, seed=0, max_bins=16):
    x, y = toy(n, d, seed)
    edges = jax_trees.compute_bin_edges(x, max_bins)
    return jax_trees.bin_features(x, edges), y.astype(np.int64)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_heaps_equal(theirs, ours):
    assert set(theirs) == set(ours)
    for k in theirs:
        want = np.asarray(theirs[k])
        got = ours[k].numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def jax_forest(binned, y, boot, masks, **kw):
    return jax_td.grow_forest(jnp.asarray(binned, jnp.int32), jnp.asarray(y, jnp.int32),
                              jnp.asarray(boot, jnp.int32), jnp.asarray(masks), **kw)


def port_forest(binned, y, boot, masks, **kw):
    return td.grow_forest(t(binned.astype(np.int64)), t(y), t(boot.astype(np.int64)),
                          t(masks), **kw)


# -- the emulated XLA arithmetic -----------------------------------------------------


def test_xla_log_is_bit_equal_to_jit_log():
    rng = np.random.RandomState(0)
    x = np.concatenate([
        rng.rand(100_000), np.float32(1e-12) * (1 + rng.rand(1000)),
        rng.randint(1, 3000, 50_000) / rng.randint(3000, 6000, 50_000), [1.0, 0.5, 1e-12],
    ]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))
    np.testing.assert_array_equal(td._xla_log(t(x)).numpy(), want)
    # torch's own log is not XLA's: the emulation is needed
    assert (torch.log(t(x)).numpy() != want).sum() > 1000


@pytest.mark.parametrize("kind", ["gini", "entropy"])
def test_impurity_is_bit_equal_to_the_jitted_one(kind):
    rng = np.random.RandomState(1)
    counts = rng.randint(0, 300, size=(20_000, 2)).astype(np.float32)
    counts[:50] = 0.0  # empty nodes
    want = np.asarray(jax.jit(lambda c: jax_td._impurity(c, kind))(jnp.asarray(counts)))
    np.testing.assert_array_equal(td._impurity(t(counts), kind).numpy(), want)


# -- masks, single trees, forests -------------------------------------------------------


@pytest.mark.parametrize("T,n_nodes,d,subset", [(1, 15, 6, None), (20, 15, 6, 3), (100, 31, 48, 7),
                                                 (5, 7, 20, 20), (3, 1, 8, 2)])
def test_draw_feature_masks_equal(T, n_nodes, d, subset):
    want = jax_td.draw_feature_masks(T, n_nodes, d, subset)
    got = td.draw_feature_masks(T, n_nodes, d, subset)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impurity,max_bins,max_depth,min_instances", [
    ("gini", 16, 4, 2), ("entropy", 8, 3, 1), ("gini", 32, 6, 1), ("entropy", 4, 2, 3),
])
def test_grow_one_equals_the_jitted_single_tree(impurity, max_bins, max_depth, min_instances):
    binned, y = binned_toy(seed=2, max_bins=max_bins)
    mask = np.ones((td.n_heap_nodes(max_depth - 1), binned.shape[1]), bool)
    kw = dict(max_bins=max_bins, impurity=impurity, max_depth=max_depth,
              min_instances=min_instances)
    want = jax.jit(lambda b, l, m: jax_td._grow_one(b, l, m, **kw))(
        jnp.asarray(binned, jnp.int32), jnp.asarray(y, jnp.int32), jnp.asarray(mask))
    got = td._grow_one(t(binned.astype(np.int64))[None], t(y)[None], t(mask)[None], **kw)
    assert_heaps_equal(want, {k: v[0] for k, v in got.items()})


@pytest.mark.parametrize("impurity", ["gini", "entropy"])
def test_grow_forest_of_20_trees_in_chunks_of_8_equals_jax(impurity):
    binned, y = binned_toy(n=600, seed=3)
    T, depth = 20, 5
    boot = np.random.RandomState(12345).randint(0, len(y), size=(T, len(y)))
    masks = td.draw_feature_masks(T, td.n_heap_nodes(depth - 1), 6, 3)
    kw = dict(max_bins=16, impurity=impurity, max_depth=depth, min_instances=1)
    assert_heaps_equal(jax_forest(binned, y, boot, masks, **kw),
                       port_forest(binned, y, boot, masks, tree_chunk=8, **kw))


@pytest.mark.parametrize("seed", range(6))
def test_forests_over_tied_features_equal_jax(seed):
    """Few distinct values, duplicate columns and small nodes: exact and
    near ties everywhere, at every subset size and both impurities."""
    rng = np.random.RandomState(seed)
    n, d = int(rng.choice([30, 120, 400])), int(rng.choice([3, 8, 20]))
    x = np.round(rng.randn(n, d) * rng.choice([2, 4, 50])) / 4
    x[:, -1] = x[:, 0]  # a duplicate column: every tie between them
    y = ((x[:, 0] + rng.randn(n)) > 0).astype(np.int64)
    max_bins, depth = int(rng.choice([4, 8, 32])), int(rng.choice([3, 5, 6]))
    T = int(rng.choice([1, 5, 11]))
    edges = jax_trees.compute_bin_edges(x, max_bins)
    binned = jax_trees.bin_features(x, edges)
    boot = np.random.RandomState(12345).randint(0, n, size=(T, n))
    masks = td.draw_feature_masks(T, td.n_heap_nodes(depth - 1), d,
                                  [None, 1, 2, max(1, d // 3)][seed % 4])
    for impurity in ("gini", "entropy"):
        kw = dict(max_bins=max_bins, impurity=impurity, max_depth=depth,
                  min_instances=int(rng.choice([1, 2])))
        assert_heaps_equal(jax_forest(binned, y, boot, masks, **kw),
                           port_forest(binned, y, boot, masks, **kw))


def test_constructed_ties_resolve_to_the_first_feature_and_bin():
    """Two identical columns and runs of empty bins give exactly equal
    gains: the split is the first (feature, bin) in both packages, as
    ``torch.argmax`` and ``jnp.argmax`` document."""
    x = np.repeat(np.array([0.0, 1.0, 2.0, 3.0]), 10)[:, None]
    x = np.concatenate([x * 0 + 5.0, x, x], axis=1)  # column 0 constant
    y = (x[:, 1] >= 2.0).astype(np.int64)
    edges = trees.compute_bin_edges(x, 16)
    binned = trees.bin_features(x, edges)
    assert np.isinf(edges[1, 4:]).all()  # padded bins: empty, tied
    mask = np.ones((1, td.n_heap_nodes(1), 3), bool)
    kw = dict(max_bins=16, impurity="gini", max_depth=2, min_instances=1)
    got = td._grow_one(t(binned.astype(np.int64))[None], t(y)[None], t(mask), **kw)
    assert int(got["feature"][0, 0]) == 1 and int(got["threshold_bin"][0, 0]) == 1
    want = jax.jit(lambda b, l, m: jax_td._grow_one(b, l, m, **kw))(
        jnp.asarray(binned, jnp.int32), jnp.asarray(y, jnp.int32), jnp.asarray(mask[0]))
    assert_heaps_equal(want, {k: v[0] for k, v in got.items()})
    # a flat score row: argmax is index 0
    flat = torch.full((3, 7), -math.inf)
    flat[1, 2:] = 0.25
    assert torch.argmax(flat, dim=1).tolist() == [0, 2, 0]


def test_predict_forest_and_heap_to_host_arrays_equal_jax():
    binned, y = binned_toy()
    boot = np.random.RandomState(12345).randint(0, len(y), size=(3, len(y)))
    masks = td.draw_feature_masks(3, td.n_heap_nodes(3), 6, 3)
    kw = dict(max_bins=16, impurity="gini", max_depth=4, min_instances=1)
    theirs = jax_forest(binned, y, boot, masks, **kw)
    ours = port_forest(binned, y, boot, masks, **kw)
    want = np.asarray(jax_td.predict_forest(theirs, jnp.asarray(binned, jnp.int32), 4))
    got = td.predict_forest(ours, t(binned.astype(np.int64)), 4)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # heap_to_host_arrays takes the JAX package's arrays unchanged
    from_jax = td.heap_to_host_arrays({k: np.asarray(v) for k, v in theirs.items()})
    for a, b, c in zip(from_jax, td.heap_to_host_arrays(ours),
                       jax_td.heap_to_host_arrays(theirs)):
        for k in c:
            assert a[k].dtype == b[k].dtype == c[k].dtype
            np.testing.assert_array_equal(a[k], c[k])
            np.testing.assert_array_equal(b[k], c[k])


@pytest.mark.parametrize("backend", ["host", "device"])
def test_linked_forest_walk_and_its_chunked_form_equal_jax(backend):
    x, y = toy(seed=13, n=64)
    clf = jax_trees.RandomForestClassifier(backend=backend)
    clf.set_config({"config_max_bins": "16", "config_impurity": "gini",
                    "config_max_depth": "4", "config_min_instances_per_node": "1",
                    "config_num_trees": "9", "config_feature_subset": "all"})
    clf.fit(x, y)
    binned = jax_trees.bin_features(x, clf.edges)
    packed_jax = jax_td.host_trees_to_device(clf.trees)
    packed = td.host_trees_to_device(clf.trees, "cpu")
    for a, b in zip(packed_jax, packed):
        assert b.dtype == getattr(torch, str(np.asarray(a).dtype))
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    want = np.asarray(jax_td.predict_linked_forest(*packed_jax, jnp.asarray(binned, jnp.int32)))
    got = td.predict_linked_forest(*packed, t(binned.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    chunked = td.predict_linked_forest_chunked(*packed, t(binned.astype(np.int64)), row_chunk=16)
    np.testing.assert_array_equal(chunked.numpy(), want)
    with pytest.raises(ValueError, match="multiple of row_chunk"):
        td.predict_linked_forest_chunked(*packed, t(binned.astype(np.int64)), row_chunk=48)


def test_regression_grower_on_quantized_residuals_equals_jax():
    """Residuals on multiples of 1/64 sum exactly in float32 in any order:
    the device regression grower is bit-equal to the jitted one."""
    rng = np.random.RandomState(4)
    n, d = 300, 5
    x = rng.randn(n, d)
    residual = rng.randint(-64, 65, size=n).astype(np.float32) / 64.0
    edges = jax_trees.compute_bin_edges(x, 16)
    binned = jax_trees.bin_features(x, edges)
    kw = dict(max_bins=16, max_depth=4, min_instances=1)
    want = jax.jit(lambda b, r: jax_td._grow_one_reg(b, r, **kw))(
        jnp.asarray(binned, jnp.int32), jnp.asarray(residual))
    got = td._grow_one_reg(t(binned.astype(np.int64)), t(residual), **kw)
    assert_heaps_equal(want, got)


def node_rows(tree, r, k, binned):
    """The rows round ``r``'s heap tree routes to node ``k``."""
    rows = np.ones(binned.shape[0], bool)
    path = []
    while k > 0:
        path.append(k)
        k = (k - 1) // 2
    node = 0
    for child in reversed(path):
        f, b = tree["feature"][r, node], tree["threshold_bin"][r, node]
        rows &= (binned[:, f] <= b) if child == 2 * node + 1 else (binned[:, f] > b)
        node = child
    return rows


def residuals_at(heaps, r, binned, y, learning_rate, max_depth):
    """The port's float32 residuals ``y - sigmoid(F)`` entering round ``r``."""
    b = t(binned.astype(np.int64))
    F = torch.zeros(len(y))
    for i in range(r):
        contrib = td._predict_heap_tree(*(t(heaps[k][i]) for k in (
            "feature", "threshold_bin", "prediction")), b, max_depth)
        F = td._fma(contrib, learning_rate, F)
    return (t(y.astype(np.float32)) - torch.sigmoid(F.double()).float()).double().numpy()


def split_score(rows, residual, column, b):
    """``sl^2/nl + sr^2/nr`` of the split ``bin <= b`` over ``rows``, float64."""
    left = column[rows] <= b
    r = residual[rows]
    return r[left].sum() ** 2 / left.sum() + r[~left].sum() ** 2 / (~left).sum()


def below(k, j):
    """Heap node ``k`` lies in the subtree under node ``j``."""
    while k > j:
        k = (k - 1) // 2
    return k == j


def check_boost(binned, y, rounds, learning_rate=0.1, max_depth=3):
    """boost_gbt against the JAX package's. Every split the two choose
    differently is explained: the same partition of the node's rows (an
    exact tie broken by float32 summation order), or a near tie whose two
    scores, recomputed in float64 from the port's residuals, lie within
    GAP_TOL of each other. Returns (ties, near ties, leaf dev, prediction
    flips); with no near tie, every prediction flip lies within F_NEAR
    of 0."""
    kw = dict(rounds=rounds, learning_rate=learning_rate, max_bins=32, max_depth=max_depth,
              min_instances=1)
    theirs = {k: np.asarray(v) for k, v in jax_td.boost_gbt(
        jnp.asarray(binned, jnp.int32), jnp.asarray(y, jnp.float32), **kw).items()}
    ours = {k: v.numpy() for k, v in td.boost_gbt(
        t(binned.astype(np.int64)), t(y.astype(np.float32)), **kw).items()}
    ties, near = 0, []
    first_near, near_nodes = rounds, []
    for r, k in zip(*np.nonzero((ours["feature"] != theirs["feature"])
                                | (ours["threshold_bin"] != theirs["threshold_bin"]))):
        if r > first_near:
            break  # the trees after a near tie grow from other residuals
        if any(below(k, j) for j in near_nodes):
            continue  # under a near tie the nodes hold other rows
        rows = node_rows(ours, r, k, binned)
        assert (rows == node_rows(theirs, r, k, binned)).all()
        fo, bo = ours["feature"][r, k], ours["threshold_bin"][r, k]
        fj, bj = theirs["feature"][r, k], theirs["threshold_bin"][r, k]
        if fo >= 0 and fj >= 0 and ((binned[rows, fo] <= bo) == (binned[rows, fj] <= bj)).all():
            ties += 1
            continue
        assert fo >= 0 and fj >= 0, f"round {r} node {k}: split on one side only"
        residual = residuals_at(ours, r, binned, y, learning_rate, max_depth)
        a = split_score(rows, residual, binned[:, fo], bo)
        b = split_score(rows, residual, binned[:, fj], bj)
        gap = abs(a - b) / abs(a)
        assert gap <= GAP_TOL, f"round {r} node {k}: scores {a} and {b}"
        near.append(gap)
        first_near = r
        near_nodes.append(k)
    F = {}
    for name, heaps in (("ours", ours), ("theirs", theirs)):
        F[name] = np.zeros(len(y))
        for trees_ in jax_td.heap_to_host_arrays(heaps):
            F[name] += learning_rate * jax_trees._predict_tree(trees_, binned)
    differ = (F["ours"] >= 0) != (F["theirs"] >= 0)
    leaf_dev = float(np.abs(ours["prediction"][:first_near]
                            - theirs["prediction"][:first_near]).max())
    assert leaf_dev <= LEAF_TOL
    if not near:
        assert (np.abs(F["ours"][differ]) < F_NEAR).all()
    return ties, near, leaf_dev, int(differ.sum())


def test_boost_gbt_15_rounds_within_the_stated_tolerance():
    x, y = toy(seed=9)
    edges = jax_trees.compute_bin_edges(x, 32)
    binned = jax_trees.bin_features(x, edges)
    ties, near, leaf_dev, pred_flips = check_boost(binned, y, rounds=15, learning_rate=0.2)
    print(f"boost_gbt 15 rounds: split ties {ties}, near ties {near}, leaf dev {leaf_dev:.3g}, "
          f"prediction flips {pred_flips}")
    assert ties == 0 and not near and pred_flips == 0


@pytest.mark.parametrize("seed", [3, 5])
def test_boost_gbt_100_rounds_flips_only_at_ties(seed):
    """At the smoke session's size (1,494 L2-normalized float32 rows x 48,
    the defaults: 100 rounds, depth 3, 32 bins) some rounds pick another
    (feature, bin) than the JAX package does; each is counted and
    explained by an identical partition or a score gap under GAP_TOL."""
    rng = np.random.RandomState(seed)
    x = rng.randn(1494, 48)
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32).astype(np.float64)
    y = ((x[:, 0] + x[:, 5] + 0.2 * rng.randn(1494)) > 0).astype(np.float64)
    edges = jax_trees.compute_bin_edges(x, 32)
    binned = jax_trees.bin_features(x, edges)
    ties, near, leaf_dev, pred_flips = check_boost(binned, y, rounds=100)
    print(f"boost_gbt 100 rounds (seed {seed}): split ties {ties}, near ties (score gaps) "
          f"{near}, leaf dev before the first near tie {leaf_dev:.3g}, prediction flips "
          f"{pred_flips} of {len(y)}")


def test_device_depth_is_checked_before_growth():
    binned, y = binned_toy(n=50)
    boot = np.arange(50)[None]
    masks = np.ones((1, td.n_heap_nodes(12), 6), bool)
    msg = "device tree backend supports max_depth <= 12"
    with pytest.raises(ValueError, match=msg):
        port_forest(binned, y, boot, masks, max_bins=16, impurity="gini", max_depth=13,
                    min_instances=1)
    with pytest.raises(ValueError, match=msg):
        td.boost_gbt(t(binned.astype(np.int64)), t(y.astype(np.float32)), rounds=2,
                     learning_rate=0.1, max_bins=16, max_depth=13, min_instances=1)
    with pytest.raises(ValueError, match=msg):
        jax_td._check_device_depth(13)
