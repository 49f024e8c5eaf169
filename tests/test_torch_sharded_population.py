"""The port's member-sharded population and tree-parallel forest growth
against the JAX package's, on logical CPU shards.

Twins of ``tests/test_sharded_population.py`` and
``tests/test_trees_device.py::test_grow_forest_sharded_matches_unsharded``.
The JAX package's own mesh pins fail on some hosts, so the port's meshed
runs are held against the JAX package's unmeshed ones, and against the
port's unmeshed ones:

- ``train_linear_population_sharded`` (11 members on 8 shards: 5 inert
  padded ones; a multi-fold mini-batch population) against the JAX
  package's vmapped engine and the port's batched engine at 5e-6 (the
  JAX package's own tolerance: a shard's engine runs fewer members at
  once, so its products may round in another order; measured 6.0e-8
  against both);
- padded members inert: an all-zero sample mask leaves a member's
  weights exactly zero, in both packages;
- ``devices=8``, ``devices=1``, ``devices=3`` and
  ``mesh_axes=data:2,time:4`` runs of the JAX test's population query:
  ``str(statistics)`` equal to the port's unmeshed run and to the JAX
  package's unmeshed run, byte for byte; ``mesh_resolved`` and the run
  report's ``mesh`` block with the JAX package's keys;
- an nn population keeps the single-device rule
  (``population.mesh_unsupported_family``), its statistics unchanged;
- ``grow_forest_sharded`` on 8 shards (8 and 11 trees) bit-equal to
  ``grow_forest``, and to the JAX package's ``grow_forest``.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.models import sgd as jax_sgd
from eeg_dataanalysispackage_tpu.models import trees as jax_trees
from eeg_dataanalysispackage_tpu.models import trees_device as jax_td
from eeg_dataanalysispackage_tpu.parallel import population as jax_engines
from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu_torch import obs
from eeg_dataanalysispackage_tpu_torch.models import sgd, trees_device as td
from eeg_dataanalysispackage_tpu_torch.parallel import mesh as pmesh, population as engines
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402

WEIGHT_TOL = 5e-6  # the JAX package's sharded-against-vmapped tolerance

_POP_QUERY = (
    "train_clf=logreg&cv=2&sweep=lr:1.0,0.5&cache=false"
    "&config_num_iterations=12&config_step_size=1.0"
    "&config_mini_batch_fraction=1.0"
)
_NN_QUERY = (
    "train_clf=nn&seeds=2&cache=false&config_seed=7&config_num_iterations=8"
    "&config_learning_rate=0.1&config_momentum=0.9&config_weight_init=xavier"
    "&config_updater=nesterovs&config_optimization_algo=stochastic_gradient_descent"
    "&config_pretrain=false&config_backprop=true&config_loss_function=xent"
    "&config_layer1_layer_type=dense&config_layer1_n_out=6"
    "&config_layer1_drop_out=0.0&config_layer1_activation_function=relu"
    "&config_layer2_layer_type=output&config_layer2_n_out=2"
    "&config_layer2_drop_out=0.0&config_layer2_activation_function=softmax"
)


@pytest.fixture(scope="module")
def mesh8():
    return pmesh.make_mesh(8, device="cpu")


def _toy(P, n=48, d=10, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    y = (rng.rand(n) > 0.5).astype(np.float32)
    steps = [1.0 + 0.05 * i for i in range(P)]
    regs = [0.0, 0.01] * (P // 2) + [0.0] * (P % 2)
    return x, y, steps, regs, list(range(P))


@pytest.mark.parametrize("P,masked,fraction", [(11, False, 1.0), (6, True, 0.7), (3, False, 1.0)])
def test_sharded_engine_matches_the_vmapped_engines(mesh8, P, masked, fraction):
    """11 members on 8 shards (5 padded), 6 multi-fold mini-batch members
    (fold masks and Bernoulli draws), 3 members (5 padded): the JAX
    package's vmapped engine and the port's batched engine at 5e-6."""
    x, y, steps, regs, seeds = _toy(P, n=40 if masked else 48)
    masks = ((np.random.RandomState(3).rand(P, x.shape[0]) > 0.3).astype(np.float32)
             if masked else None)
    kw = dict(num_iterations=6 if masked else 8, mini_batch_fraction=fraction)
    got = engines.train_linear_population_sharded(
        torch.from_numpy(x), torch.from_numpy(y), sgd.SGDConfig(**kw), steps, regs, seeds,
        masks, mesh8)
    assert got.shape == (P, 10)
    ours, _, _ = engines.train_linear_population(
        torch.from_numpy(x), torch.from_numpy(y), sgd.SGDConfig(**kw), steps, regs, seeds,
        masks)
    # a shard's engine runs fewer members at once: its products may round
    # in another order than the whole population's
    np.testing.assert_allclose(got.numpy(), ours.numpy(), rtol=0, atol=WEIGHT_TOL)
    theirs = np.asarray(jax_engines.train_linear_population(
        x, y, jax_sgd.SGDConfig(**kw), steps, regs, seeds, masks=masks))
    np.testing.assert_allclose(got.numpy(), theirs, rtol=0, atol=WEIGHT_TOL)


def test_padded_member_masks_are_inert(mesh8):
    assert engines.pad_members(3, 8) == 8 and engines.pad_members(16, 8) == 16
    x, y, steps, regs, seeds = _toy(1)
    w, converged, n_updates = engines.train_linear_population(
        torch.from_numpy(x), torch.from_numpy(y), sgd.SGDConfig(num_iterations=5), steps, regs,
        seeds, np.zeros((1, x.shape[0]), np.float32))
    assert float(w.abs().sum()) == 0.0 and int(n_updates[0]) == 0
    theirs = jax_sgd._run_sgd(
        jnp.asarray(x), jnp.asarray(y), 1.0, 1.0, 0.0, 1, 0.001,
        sample_mask=jnp.zeros_like(jnp.asarray(y)), num_iterations=5, loss="logistic",
        full_batch=True)
    assert float(np.abs(np.asarray(theirs)).sum()) == 0.0


def _session(directory, n_files=2, n_markers=60):
    lines = []
    for i in range(n_files):
        name = f"synth_{i:02d}"
        _synthetic.write_recording(str(directory), name=name, n_markers=n_markers,
                                   guessed=2 + i, seed=i)
        lines.append(f"{name}.eeg {2 + i}")
    info = os.path.join(str(directory), "info.txt")
    with open(info, "w") as f:
        f.write("\n".join(lines) + "\n")
    return info


@pytest.fixture(scope="module")
def info(tmp_path_factory):
    return _session(tmp_path_factory.mktemp("torch_mesh_session"))


def _q(info, *parts):
    return "&".join([f"info_file={info}", "fe=dwt-8-fused", *parts])


@pytest.fixture(scope="module")
def unmeshed(info):
    """(the port's unmeshed statistics text, the JAX package's)."""
    ours = str(PipelineBuilder(_q(info, _POP_QUERY), device="cpu").execute())
    return ours, str(JaxBuilder(_q(info, _POP_QUERY)).execute())


@pytest.mark.parametrize("extra,shape,per_device,padded", [
    ("devices=8", {"data": 8}, 1, 4),
    ("devices=1", {"data": 1}, 4, 0),
    ("devices=3", {"data": 3}, 2, 2),
    ("mesh_axes=data:2,time:4", {"data": 2, "time": 4}, 2, 0),
])
def test_meshed_statistics_equal_the_unmeshed_runs(info, unmeshed, extra, shape, per_device,
                                                   padded):
    before = obs.metrics.snapshot()["counters"].get("ingest.sharded_recordings", 0.0)
    pb = PipelineBuilder(_q(info, _POP_QUERY, extra), device="cpu")
    meshed = str(pb.execute())
    after = obs.metrics.snapshot()["counters"].get("ingest.sharded_recordings", 0.0)
    assert meshed == unmeshed[0]
    assert meshed == unmeshed[1]
    resolved = pb.mesh_resolved
    assert resolved["rung"] == "mesh" and resolved["shape"] == shape
    assert resolved["devices"] == int(np.prod(list(shape.values())))
    pop = resolved["population"]
    assert pop["rung"] == "mesh" and pop["axis"] == "data"
    assert pop["members_per_device"] == per_device and pop["padded_members"] == padded
    assert pb.population_block["mode"] == "sharded"
    # the fused ingest shards over the time axis, else the mesh's last
    sharded = (shape.get("time") or shape.get("data")) >= 2
    assert after - before == (2 if sharded else 0)


def test_the_run_report_carries_the_mesh_block(info, tmp_path):
    report_dir = tmp_path / "report"
    pb = PipelineBuilder(_q(info, _POP_QUERY, "devices=8", f"report={report_dir}"),
                         device="cpu")
    pb.execute()
    with open(report_dir / "run_report.json") as f:
        report = json.load(f)
    assert report["mesh"]["rung"] == "mesh"
    assert report["mesh"]["shape"] == {"data": 8}
    assert report["mesh"]["requested"] == {"devices": 8, "axes": ["data"], "shape": None}
    assert report["mesh"]["population"]["members_per_device"] == 1
    assert report["population"]["mode"] == "sharded"
    # an unmeshed run reports no mesh, as the JAX package's does
    plain_dir = tmp_path / "plain"
    PipelineBuilder(_q(info, _POP_QUERY, f"report={plain_dir}"), device="cpu").execute()
    with open(plain_dir / "run_report.json") as f:
        assert json.load(f)["mesh"] is None


def test_nn_populations_keep_the_single_device_rule(info):
    unmeshed = str(PipelineBuilder(_q(info, _NN_QUERY), device="cpu").execute())
    before = obs.metrics.snapshot()["counters"].get("population.mesh_unsupported_family", 0)
    pb = PipelineBuilder(_q(info, _NN_QUERY, "devices=2"), device="cpu")
    assert str(pb.execute()) == unmeshed
    after = obs.metrics.snapshot()["counters"].get("population.mesh_unsupported_family", 0)
    assert after == before + 1
    assert pb.population_block["mode"] == "vmap"
    assert pb.population_block["mesh"]["rung"] == "single_device"
    assert pb.mesh_resolved["population"]["rung"] == "single_device"


def test_looped_populations_train_single_device(info, unmeshed):
    pb = PipelineBuilder(_q(info, _POP_QUERY, "population_mode=looped", "devices=2"),
                         device="cpu")
    assert str(pb.execute()) == unmeshed[0]
    assert pb.population_block["mode"] == "looped"
    assert pb.population_block["mesh"]["rung"] == "single_device"


def _toy_forest(T):
    rng = np.random.RandomState(0)
    x = rng.randn(200, 6)
    y = ((x[:, 0] + 0.5 * x[:, 2] - 0.25 * x[:, 4]) > 0).astype(np.int64)
    binned = jax_trees.bin_features(x, jax_trees.compute_bin_edges(x, 16))
    boot = np.random.RandomState(12345).randint(0, len(y), size=(T, len(y)))
    masks = td.draw_feature_masks(T, td.n_heap_nodes(3), 6, 3)
    return binned.astype(np.int64), y, boot.astype(np.int64), masks


@pytest.mark.parametrize("T", [8, 11])
def test_grow_forest_sharded_matches_unsharded(mesh8, T):
    binned, y, boot, masks = _toy_forest(T)
    kw = dict(max_bins=16, impurity="gini", max_depth=3, min_instances=1)
    t = torch.from_numpy
    ref = td.grow_forest(t(binned), t(y), t(boot), t(masks), **kw)
    got = td.grow_forest_sharded(t(binned), t(y), t(boot), t(masks), mesh=mesh8, **kw)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape[0] == T
        assert torch.equal(got[k], ref[k]), k
    theirs = jax_td.grow_forest(jnp.asarray(binned, jnp.int32), jnp.asarray(y, jnp.int32),
                                jnp.asarray(boot, jnp.int32), jnp.asarray(masks), **kw)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(theirs[k]), err_msg=k)
