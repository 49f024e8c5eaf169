"""The port's device meshes against the JAX package's ``parallel/mesh.py``
and its plan parser's ``devices=``/``mesh_axes=`` grammar.

Twins of ``tests/test_parallel.py``'s mesh tests on N logical CPU shards
(``make_mesh(..., device="cpu")``, the counterpart of the 8 forced host
devices of the JAX tests): construction, 2-D layouts and their axis
devices, the shape errors with the JAX package's messages; the grammar
errors, each message equal to the JAX package's; ``pad_to_multiple`` and
``shard_batch_with_mask`` equal to the JAX package's padded arrays and
mask (exact); a card request with more cards than visible raising; and
explicit device lists, repeats included.
"""

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.parallel import mesh as jax_mesh
from eeg_dataanalysispackage_tpu.pipeline.plan import ExecutionPlan
from eeg_dataanalysispackage_tpu_torch.parallel import mesh as pmesh
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder


def test_mesh_construction_1d():
    mesh = pmesh.make_mesh(8, device="cpu")
    assert mesh.shape == {"data": 8}
    assert mesh.axis_names == ("data",)
    assert mesh.devices.size == 8
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert mesh.first_device == torch.device("cpu")


def test_mesh_construction_2d_and_axis_devices():
    devices = [f"cpu:{i}" for i in range(8)]
    mesh = pmesh.make_mesh(8, axes=(pmesh.DATA_AXIS, pmesh.TIME_AXIS), shape=(2, 4),
                           devices=devices)
    assert mesh.shape == {"data": 2, "time": 4}
    assert mesh.axis_names == (pmesh.DATA_AXIS, pmesh.TIME_AXIS)
    # row-major, as jax.sharding.Mesh lays its device array out
    assert [str(d) for d in mesh.axis_devices("time")] == [f"cpu:{i}" for i in range(4)]
    assert [str(d) for d in mesh.axis_devices("data")] == ["cpu:0", "cpu:4"]


@pytest.mark.parametrize("kwargs,match", [
    (dict(axes=("data", "time"), shape=(3, 2)), "multiply to the device count"),
    (dict(axes=("data", "time"), shape=(8,)), "one extent per axis"),
    (dict(axes=("data", "time")), "shape required"),
])
def test_mesh_shape_errors_carry_the_jax_messages(kwargs, match):
    with pytest.raises(ValueError, match=match) as ours:
        pmesh.make_mesh(8, device="cpu", **kwargs)
    with pytest.raises(ValueError) as theirs:
        jax_mesh.make_mesh(8, **kwargs)
    assert str(ours.value) == str(theirs.value)


def test_explicit_device_lists_may_repeat_and_must_agree():
    mesh = pmesh.make_mesh(devices=["cpu"] * 4, axes=("time",))
    assert mesh.shape == {"time": 4}
    with pytest.raises(ValueError, match="they must agree"):
        pmesh.make_mesh(3, devices=["cpu"] * 4)


def test_a_card_request_past_the_visible_cards_raises():
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        with pytest.raises(ValueError, match=f"requested {n + 1} devices, only {n} present"):
            pmesh.make_mesh(n + 1)
        return
    # device=None means the card: without one the request raises, and
    # nothing falls back to CPU shards
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.make_mesh(2)


def test_pad_to_multiple_matches_the_jax_package():
    x = np.arange(33, dtype=np.float32).reshape(11, 3)
    ours, n = pmesh.pad_to_multiple(x, 8)
    theirs, n2 = jax_mesh.pad_to_multiple(x, 8)
    assert n == n2 == 11 and ours.shape == (16, 3)
    np.testing.assert_array_equal(ours, theirs)
    same, n3 = pmesh.pad_to_multiple(np.ones((16, 3)), 8)
    assert same.shape == (16, 3) and n3 == 16


def test_shard_batch_with_mask_matches_the_jax_package():
    rng = np.random.RandomState(0)
    x = rng.randn(13, 5).astype(np.float64)
    y = (rng.rand(13) > 0.5).astype(np.int64)
    mesh = pmesh.make_mesh(4, device="cpu")
    xs, ys, mask = pmesh.shard_batch_with_mask(mesh, x, y)
    assert [s.shape[0] for s in xs.shards] == [4, 4, 4, 4]
    assert xs.shape == (16, 5) and len(xs.devices) == 4
    assert all(s.dtype == torch.float32 for s in xs.shards)
    jx, jy, jmask = jax_mesh.shard_batch_with_mask(jax_mesh.make_mesh(4), x, y)
    np.testing.assert_array_equal(xs.gather().numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ys.gather().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(mask.gather().numpy(), np.asarray(jmask))
    assert float(mask.sum()) == 13.0


def test_sharded_array_split_multiply_and_ordered_sum():
    mesh = pmesh.make_mesh(3, device="cpu")
    xs, _ = pmesh.shard_batch(np.arange(9, dtype=np.float32), mesh)
    full = torch.arange(9, dtype=torch.float32) * 2
    prod = xs * full
    assert torch.equal(prod.gather(), torch.arange(9, dtype=torch.float32) ** 2 * 2)
    assert float(xs.sum()) == 36.0


@pytest.mark.parametrize("bad", [
    "devices=0",
    "devices=x",
    "mesh_axes=data:x",
    "mesh_axes=data,data",
    "mesh_axes=data,time",
    "mesh_axes=data:2,time",
    "mesh_axes=,time:2",
    "mesh_axes=data:2,time:2&devices=8",
    "devices=2&serve=true",
])
def test_grammar_errors_carry_the_jax_messages(bad, tmp_path):
    q = f"info_file={tmp_path}/absent.txt&fe=dwt-8-fused&train_clf=logreg&{bad}"
    with pytest.raises(ValueError) as theirs:
        ExecutionPlan.parse(q)
    with pytest.raises(ValueError) as ours:
        PipelineBuilder(q, device="cpu").execute()
    assert str(ours.value) == str(theirs.value)


def test_parse_mesh_typed_request():
    assert pmesh.parse_mesh({"fe": "x"}, serve=False) is None
    assert pmesh.parse_mesh({"devices": "4"}, serve=False) == pmesh.MeshRequest(4, ("data",), None)
    req = pmesh.parse_mesh({"mesh_axes": "data:2,time:4"}, serve=False)
    assert req == pmesh.MeshRequest(None, ("data", "time"), (2, 4))
    jax_req = ExecutionPlan.parse("info_file=i&fe=dwt-8-fused&train_clf=logreg"
                                  "&mesh_axes=data:2,time:4").mesh
    assert (req.devices, req.axes, req.shape) == (jax_req.devices, jax_req.axes, jax_req.shape)
