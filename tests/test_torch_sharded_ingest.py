"""The port's time-sharded fused ingest (``parallel/sharded_ingest.py``)
against the JAX package's, on 8 logical CPU shards.

Twins of ``tests/test_sharded_ingest.py``'s five tests (markers next to
shard boundaries, windows reaching back into the previous shard, markers
on a boundary, a window overhanging the end reading zeros, the balance
scan, the layout checks), each held against the JAX package's sharded
ingest on its 8 forced host devices, or against its unsharded block
featurizer where fewer are present (its own tests' reference), at 5e-5
(the block formulation's two-term numerics against the port's
subtract-first rows), and against the port's unsharded kernel bit for
bit: the sharded rows are the plain version's rows of the same windows.
The provider's mesh path: ``load_features_device(mesh=)`` bit-equal to
the unmeshed run with every recording counted in
``ingest.sharded_recordings``, within 1e-5 of the JAX package's unmeshed
decode rung (its own test's contract), and an IEEE_FLOAT_32 session
routed to the unsharded kernel by its header
(``ingest.sharded_fallback``).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.io import provider as jax_provider
from eeg_dataanalysispackage_tpu.ops import device_ingest as jax_device_ingest
from eeg_dataanalysispackage_tpu.parallel import mesh as jax_mesh
from eeg_dataanalysispackage_tpu.parallel import sharded_ingest as jax_sharded
from eeg_dataanalysispackage_tpu_torch import obs
from eeg_dataanalysispackage_tpu_torch.io.brainvision import Marker
from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider
from eeg_dataanalysispackage_tpu_torch.ops import device_ingest, ingest_cuda
from eeg_dataanalysispackage_tpu_torch.parallel import mesh as pmesh, sharded_ingest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402
import _torch_sessions  # noqa: E402

JAX_TOL = 5e-5  # the JAX package's block/bank rows against subtract-first ones
T = 8 * 4096
BLOCK = T // 8


@pytest.fixture(scope="module")
def tmesh():
    return pmesh.make_mesh(8, axes=(pmesh.TIME_AXIS,), device="cpu")


@pytest.fixture(scope="module")
def jax_extract():
    """The JAX package's sharded extractor on its 8 host devices, else
    None (then its unsharded block featurizer is the reference)."""
    if len(jax.devices()) < 8:
        return None
    jm = jax_mesh.make_mesh(8, axes=(jax_mesh.TIME_AXIS,))
    return jm, jax_sharded.make_sharded_ingest(jm)


def _markers(positions, stimuli):
    return [Marker(f"Mk{i}", "Stimulus", f"S  {s}", int(p))
            for i, (p, s) in enumerate(zip(positions, stimuli))]


def _recording(seed=0):
    rng = np.random.RandomState(seed)
    dc = np.array([[1500], [-900], [400]], np.int16)
    raw = (rng.randint(-3000, 3000, size=(3, T)) + dc).astype(np.int16)
    return raw, np.array([0.1, 0.1, 0.2], np.float32)


def _unsharded(raw, res, markers, guessed):
    base = device_ingest.plan_ingest(markers, guessed, T)
    rows = ingest_cuda.make_cuda_ingest_featurizer()(
        torch.from_numpy(raw), torch.from_numpy(res), base.positions, base.mask)
    return rows[: base.n_kept], base


def _jax_rows(jax_extract, raw, res, markers, guessed):
    from eeg_dataanalysispackage_tpu.io.brainvision import Marker as JaxMarker

    jmarkers = [JaxMarker(m.name, m.kind, m.stimulus, m.position) for m in markers]
    if jax_extract is not None:
        jm, extract = jax_extract
        plan = jax_sharded.plan_sharded_ingest(jmarkers, guessed, T, 8, BLOCK)
        return np.asarray(extract(jax_sharded.stage_recording_int16(raw, jm), res, plan))
    base = jax_device_ingest.plan_ingest(jmarkers, guessed, T)
    feat = jax_device_ingest.make_block_ingest_featurizer()
    return np.asarray(feat(jnp.asarray(raw), jnp.asarray(res), jnp.asarray(base.positions),
                           jnp.asarray(base.mask)))[base.mask]


def _check(tmesh, jax_extract, raw, res, markers, guessed):
    plan = sharded_ingest.plan_sharded_ingest(markers, guessed, T, 8, BLOCK)
    extract = sharded_ingest.make_sharded_ingest(tmesh)
    got = extract(sharded_ingest.stage_recording_int16(raw, tmesh), res, plan)
    want, base = _unsharded(raw, res, markers, guessed)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(plan.targets, base.targets)
    theirs = _jax_rows(jax_extract, raw, res, markers, guessed)
    assert got.shape == theirs.shape
    np.testing.assert_allclose(got.numpy(), theirs, rtol=0, atol=JAX_TOL)
    return plan


def test_sharded_ingest_matches_single_device(tmesh, jax_extract):
    """Markers everywhere, several right before shard boundaries so their
    windows cross into the neighbour through the halo."""
    raw, res = _recording()
    positions = [500, 3000, BLOCK - 50, BLOCK + 200, 2 * BLOCK - 10, 3 * BLOCK + 77,
                 5 * BLOCK - 100, 7 * BLOCK + 900, 6 * BLOCK + 123, 4 * BLOCK + 1]
    plan = _check(tmesh, jax_extract, raw, res,
                  _markers(positions, [1, 2, 3, 4, 5, 6, 7, 8, 9, 1]), 4)
    assert plan.halo_windows(787) >= 1


def test_sharded_ingest_backward_reach_and_exact_boundaries(tmesh, jax_extract):
    """Windows starting in the previous shard (the pre-stimulus reach) and
    markers exactly on a boundary."""
    raw, res = _recording(seed=7)
    positions = [BLOCK, BLOCK + 10, 3 * BLOCK + 99, 5 * BLOCK + 100, 7 * BLOCK]
    _check(tmesh, jax_extract, raw, res, _markers(positions, [1, 2, 3, 4, 5]), 4)


def test_sharded_ingest_end_overhang_zero_pads(tmesh, jax_extract):
    """A window overhanging the recording's end reads zeros, not the ring
    wrap of shard 0's head."""
    raw, res = _recording(seed=3)
    _check(tmesh, jax_extract, raw, res, _markers([1000, T - 200], [1, 2]), 2)


def test_sharded_ingest_balance_scan_matches_reference_semantics():
    """The balance scan runs on the host before sharding: kept markers and
    targets are the unsharded plan's, and the JAX package's."""
    from eeg_dataanalysispackage_tpu.io.brainvision import Marker as JaxMarker

    positions = list(range(500, T - 1000, 2500))
    stimuli = [(i % 9) + 1 for i in range(len(positions))]
    markers = _markers(positions, stimuli)
    plan = sharded_ingest.plan_sharded_ingest(markers, 3, T, 8, BLOCK)
    base = device_ingest.plan_ingest(markers, 3, T)
    np.testing.assert_array_equal(plan.targets, base.targets)
    np.testing.assert_array_equal(plan.stimulus_indices, base.stimulus_indices)
    theirs = jax_sharded.plan_sharded_ingest(
        [JaxMarker(m.name, m.kind, m.stimulus, m.position) for m in markers], 3, T, 8,
        BLOCK)
    for name in ("local_positions", "mask", "unsort", "targets", "stimulus_indices"):
        np.testing.assert_array_equal(getattr(plan, name), getattr(theirs, name))


def test_sharded_ingest_rejects_bad_layouts(tmesh):
    raw, res = _recording(seed=1)
    extract = sharded_ingest.make_sharded_ingest(tmesh)
    plan = sharded_ingest.plan_sharded_ingest(_markers([1000], [1]), 1, T, 8, BLOCK)
    with pytest.raises(ValueError, match="divisible"):
        extract(raw[:, : T - 4], res, plan)
    with pytest.raises(ValueError, match="halo"):
        extract(np.zeros((3, 8 * 512), np.int16), res, plan)
    with pytest.raises(ValueError, match="re-plan"):
        extract(raw, res, sharded_ingest.plan_sharded_ingest(_markers([1000], [1]), 1, T, 4,
                                                             T // 4))
    with pytest.raises(ValueError, match="halo of the sharded ingest"):
        sharded_ingest.make_sharded_ingest(tmesh, skip_samples=500)


def test_shard_block_for_matches_the_jax_package():
    for n, shards in ((100, 8), (30_000, 8), (1_000_003, 4), (4096 * 8, 8)):
        assert sharded_ingest.shard_block_for(n, shards) == jax_sharded.shard_block_for(n, shards)


@pytest.fixture(scope="module")
def info(tmp_path_factory):
    directory = tmp_path_factory.mktemp("torch_sharded_session")
    lines = []
    for i in range(2):
        _synthetic.write_recording(str(directory), name=f"s{i}", n_markers=60,
                                   guessed=2 + i, seed=i)
        lines.append(f"s{i}.eeg {2 + i}")
    path = os.path.join(str(directory), "info.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _counter(name):
    return obs.metrics.snapshot()["counters"].get(name, 0.0)


@pytest.mark.parametrize("axes,shape", [(("time",), (8,)), (("data", "time"), (2, 4)),
                                        (("data",), (3,))])
def test_provider_mesh_path_equals_the_unmeshed_run(info, axes, shape):
    f0, t0 = OfflineDataProvider([info], device="cpu").load_features_device()
    mesh = pmesh.make_mesh(int(np.prod(shape)), axes=axes, shape=shape, device="cpu")
    before = (_counter("ingest.sharded_recordings"), _counter("ingest.sharded_fallback"))
    f1, t1 = OfflineDataProvider([info], device="cpu").load_features_device(mesh=mesh)
    after = (_counter("ingest.sharded_recordings"), _counter("ingest.sharded_fallback"))
    np.testing.assert_array_equal(t0, t1)
    assert torch.equal(f0, f1)
    assert (after[0] - before[0], after[1] - before[1]) == (2, 0)
    jf, jt = jax_provider.OfflineDataProvider([info]).load_features_device(backend="decode")
    np.testing.assert_array_equal(jt, t1)
    assert float(np.max(np.abs(jf - f1.numpy()))) <= 1e-5


def test_provider_routes_a_float_stream_to_the_unsharded_kernel(tmp_path):
    line = _torch_sessions.write_coded_recording(str(tmp_path), "f0", "IEEE_FLOAT_32",
                                                 n_markers=40, guessed=3, seed=0)
    info = tmp_path / "info.txt"
    info.write_text(line + "\n")
    f0, t0 = OfflineDataProvider([str(info)], device="cpu").load_features_device()
    mesh = pmesh.make_mesh(4, axes=("time",), device="cpu")
    before = (_counter("ingest.sharded_recordings"), _counter("ingest.sharded_fallback"))
    f1, t1 = OfflineDataProvider([str(info)], device="cpu").load_features_device(mesh=mesh)
    after = (_counter("ingest.sharded_recordings"), _counter("ingest.sharded_fallback"))
    assert (after[0] - before[0], after[1] - before[1]) == (0, 1)
    assert torch.equal(f0, f1)
    np.testing.assert_array_equal(t0, t1)
