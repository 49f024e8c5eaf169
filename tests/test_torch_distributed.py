"""The port's multi-process runtime (``parallel/distributed.py``) against the
JAX package's ``tests/test_distributed.py``.

Single-process: ``initialize`` is a no-op, ``hybrid_mesh`` degenerates to
one host (hosts x local devices; on the CPU one logical device unless
``ici_shape`` asks for more, where the JAX package's CPU host has 8),
``batch_spec`` names the data-parallel axes, ``stage_global_batch`` and
``replicate_across_hosts`` stage as one process does, and the flagship
train step over a hosts x data layout matches the single-device step and
the JAX package's. Two processes over gloo
(``tests/_torch_distributed_worker.py``): the cross-process sums, the
train step, the streaming extractor and the sharded marker ingest whose
halos cross the process boundary, data-parallel SGD and the member-sharded
population give the bits of one process over the same four shards, and
stay within the JAX package's tolerances of its own runs.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.ops import device_ingest as jax_device_ingest
from eeg_dataanalysispackage_tpu.parallel import mesh as jax_mesh
from eeg_dataanalysispackage_tpu.parallel import streaming as jax_streaming
from eeg_dataanalysispackage_tpu.parallel import train as jax_train
from eeg_dataanalysispackage_tpu_torch.models import sgd
from eeg_dataanalysispackage_tpu_torch.ops import device_ingest, ingest_cuda
from eeg_dataanalysispackage_tpu_torch.parallel import (
    distributed, mesh as pmesh, population, sharded_ingest, streaming, train as ptrain,
)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_distributed_worker as worker  # noqa: E402

WEIGHT_TOL = 5e-6  # sharded population members (the JAX package's)
SGD_TOL = 2e-5  # data-parallel SGD against one device (the JAX package's)


def _arr(hexed, shape=None):
    a = np.frombuffer(bytes.fromhex(hexed), dtype=np.float32)
    return a if shape is None else a.reshape(shape)


@pytest.fixture(autouse=True)
def _no_pod_env(monkeypatch):
    for var in ("JAX_NUM_PROCESSES", "JAX_COORDINATOR", "JAX_COORDINATOR_ADDRESS",
                "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)


# -- one process ----------------------------------------------------------


def test_initialize_single_process_noop():
    assert distributed.initialize() == (None, 1, 0)
    assert distributed.process_count() == 1 and distributed.backend() is None


def test_hybrid_mesh_degenerates_single_process():
    mesh = distributed.hybrid_mesh(device="cpu")
    assert mesh.axis_names == (distributed.DCN_AXIS, pmesh.DATA_AXIS)
    assert mesh.shape == {"hosts": 1, "data": 1}
    assert (mesh.process_count, mesh.process_id, mesh.process_axis) == (1, 0, "hosts")
    wide = distributed.hybrid_mesh(ici_shape=(8,), device="cpu")
    assert wide.shape == {"hosts": 1, "data": 8} and len(wide.local_devices) == 8
    assert wide.is_local((0, 5))


def test_hybrid_mesh_rejects_bad_ici_shape():
    with pytest.raises(ValueError, match="ici_shape required"):
        distributed.hybrid_mesh(ici_axes=("data", "time"), device="cpu")
    with pytest.raises(ValueError, match="local devices"):
        distributed.hybrid_mesh(ici_shape=(3,), devices=["cpu", "cpu"])


def test_batch_spec_covers_dcn_and_data_axes():
    mesh = distributed.hybrid_mesh(ici_shape=(8,), device="cpu")
    assert distributed.batch_spec(mesh) == (distributed.DCN_AXIS, pmesh.DATA_AXIS)
    assert distributed.batch_spec(pmesh.make_mesh(8, device="cpu")) == pmesh.DATA_AXIS
    with pytest.raises(ValueError, match="no data-parallel axis"):
        distributed.batch_spec(pmesh.make_mesh(8, axes=(pmesh.TIME_AXIS,), device="cpu"))


def test_stage_global_batch_single_process():
    mesh = distributed.hybrid_mesh(ici_shape=(8,), device="cpu")
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    arr = distributed.stage_global_batch(x, mesh)
    assert arr.shape == (16, 3) and len(arr.shards) == 8
    np.testing.assert_array_equal(arr.gather().numpy(), x)
    with pytest.raises(ValueError, match="not divisible"):
        distributed.stage_global_batch(x[:15], mesh)


def test_replicate_across_hosts_single_process():
    mesh = distributed.hybrid_mesh(ici_shape=(8,), device="cpu")
    params = {"w": np.ones((4, 2), np.float32), "b": np.zeros(2, np.float32)}
    rep = distributed.replicate_across_hosts(params, mesh)
    np.testing.assert_array_equal(rep["w"].numpy(), params["w"])
    assert rep["b"].device == mesh.first_device


@pytest.fixture(scope="module")
def jax_params():
    init_state, _ = jax_train.make_train_step()
    return {k: np.asarray(v) for k, v in init_state(jax.random.PRNGKey(0))["params"].items()}


def test_train_step_on_hosts_by_data_layout(jax_params):
    """The flagship step over a 2 x 4 (hosts x data) layout of eight CPU
    shards, from the JAX package's initial parameters: within the JAX
    package's tolerances of the single-device step and of the JAX
    package's own step."""
    mesh2d = pmesh.make_mesh(8, axes=(distributed.DCN_AXIS, pmesh.DATA_AXIS), shape=(2, 4),
                             device="cpu")
    rng = np.random.RandomState(0)
    epochs = rng.randn(24, 3, 750).astype(np.float32)
    labels = (rng.rand(24) > 0.5).astype(np.float32)
    mask = np.ones(24, np.float32)
    init1, step1 = ptrain.make_train_step(device="cpu")
    state_ref, loss_ref = step1(init1(jax_params), epochs, labels, mask)
    init2, step2 = ptrain.make_train_step(mesh2d)
    state_dist, loss_dist = step2(init2(jax_params), epochs, labels, mask)
    np.testing.assert_allclose(float(loss_dist), float(loss_ref), atol=1e-6)
    for k in state_ref["params"]:
        np.testing.assert_allclose(state_dist["params"][k].numpy(),
                                   state_ref["params"][k].numpy(), atol=1e-5)
    jinit, jstep = jax_train.make_train_step()
    _, jloss = jstep(jinit(jax.random.PRNGKey(0)), epochs, labels, mask)
    np.testing.assert_allclose(float(loss_dist), float(jloss), rtol=1e-5)


# -- two processes ----------------------------------------------------------


def run_two_process_worker(params_path, device="cpu", timeout=240):
    """The two ranks of ``_torch_distributed_worker.py`` on a loopback
    coordinator; their JSON results in rank order."""
    port = distributed.free_port_pair()
    script = os.path.join(HERE, "_torch_distributed_worker.py")
    procs = []
    for pid in range(2):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2",
                   JAX_PROCESS_ID=str(pid), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, script, params_path, device], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:  # reap stragglers if a peer failed or hung
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.fixture(scope="module")
def two_process(tmp_path_factory, jax_params):
    path = str(tmp_path_factory.mktemp("dist") / "params.npz")
    np.savez(path, **jax_params)
    return run_two_process_worker(path)


def test_two_process_collectives(two_process):
    for pid, o in enumerate(two_process):
        assert (o["pid"], o["procs"], o["backend"]) == (pid, 2, "gloo")
        assert o["devices"] == 4
        assert o["mesh"] == {"hosts": 2, "data": 2}
        assert o["time_mesh"] == {"hosts": 2, "time": 2}
        assert o["total"] == 15.0 + 75.0
        assert o["wsum"] == 6.0
        assert o["grad"] == [26.0, 30.0, 34.0]  # global column sums


def test_two_process_train_step_is_one_process_over_four_shards(two_process, jax_params):
    """2 processes x 2 shards give the bits of 1 process x 4 shards, and
    the JAX package's single-device loss within its tolerance."""
    epochs, labels, *_ = worker.cases()
    init, step = ptrain.make_train_step(pmesh.make_mesh(4, device="cpu"))
    state, loss = step(init(jax_params), epochs, labels, np.ones(4, np.float32))
    for o in two_process:
        assert o["loss"] == two_process[0]["loss"]
        np.testing.assert_array_equal(_arr(o["loss"]), loss.reshape(1).numpy())
        for k, v in state["params"].items():
            np.testing.assert_array_equal(_arr(o["params"][k]), v.numpy().reshape(-1))
    jinit, jstep = jax_train.make_train_step()
    _, jloss = jstep(jinit(jax.random.PRNGKey(0)), epochs, labels, np.ones(4, np.float32))
    np.testing.assert_allclose(_arr(two_process[0]["loss"])[0], float(jloss), rtol=1e-5)


def test_two_process_streaming_halo_crosses_the_process_boundary(two_process):
    _, _, signal, *_ = worker.cases()
    tmesh = pmesh.make_mesh(4, axes=(pmesh.TIME_AXIS,), device="cpu")
    one = streaming.make_streaming_extractor(tmesh, window=512, stride=256)(
        streaming.stage_recording(signal, tmesh))
    jmesh = jax_mesh.make_mesh(4, axes=(jax_mesh.TIME_AXIS,))
    jfeats = np.asarray(jax_streaming.make_streaming_extractor(jmesh, window=512, stride=256)(
        jax_streaming.stage_recording(signal, jmesh)))
    for o in two_process:
        assert o["stream_shape"] == list(one.shape) == [8, 32]
        got = _arr(o["stream"], (8, 32))
        np.testing.assert_array_equal(got, one.numpy())
        np.testing.assert_allclose(got, jfeats, rtol=0, atol=2e-5)


def test_two_process_sharded_ingest_halo_crosses_the_process_boundary(two_process):
    _, _, _, raw, markers, *_ = worker.cases()
    T = raw.shape[1]
    res = np.full(3, 0.1, np.float32)
    tmesh = pmesh.make_mesh(4, axes=(pmesh.TIME_AXIS,), device="cpu")
    plan = sharded_ingest.plan_sharded_ingest(markers, 2, T, 4, T // 4)
    one = sharded_ingest.make_sharded_ingest(tmesh)(raw, res, plan)
    base = device_ingest.plan_ingest(markers, 2, T)
    plain = ingest_cuda.make_cuda_ingest_featurizer()(
        torch.from_numpy(raw), torch.from_numpy(res), base.positions, base.mask)[: base.n_kept]
    jbase = jax_device_ingest.plan_ingest(markers, 2, T)
    jref = np.asarray(jax_device_ingest.make_block_ingest_featurizer()(
        raw, res, jbase.positions, jbase.mask))[np.asarray(jbase.mask)]
    for o in two_process:
        # 4 markers -> 3 kept (the balance scan drops the last non-target)
        assert o["ingest_rows"] == 3
        got = _arr(o["ingest"], (3, 48))
        np.testing.assert_array_equal(got, one.numpy())
        np.testing.assert_array_equal(got, plain.numpy())
        np.testing.assert_allclose(got, jref, rtol=0, atol=5e-6)


def test_two_process_data_parallel_sgd(two_process):
    *_, x, y = worker.cases()
    mesh4 = pmesh.make_mesh(4, device="cpu")
    for name, cfg in worker.SGD_CONFIGS.items():
        four = sgd.train_linear(torch.from_numpy(x), torch.from_numpy(y), sgd.SGDConfig(**cfg),
                                mesh=mesh4)
        single = sgd.train_linear(torch.from_numpy(x), torch.from_numpy(y),
                                  sgd.SGDConfig(**cfg))
        for o in two_process:
            got = _arr(o["sgd"][name])
            np.testing.assert_array_equal(got, four.numpy())
            if name == "full":
                np.testing.assert_allclose(got, single.numpy(), rtol=0, atol=SGD_TOL)


def test_two_process_member_sharded_population(two_process):
    """Members over hosts x data: bit-equal to one process's 4-device
    engine (the same four-member blocks), within the JAX package's 5e-6 of
    the unsharded engine; the members that round apart are counted."""
    *_, x, y = worker.cases()
    steps, regs, seeds = worker.population_args()
    cfg = sgd.SGDConfig(num_iterations=200, convergence_tol=0.0)
    args = (torch.from_numpy(x), torch.from_numpy(y), cfg, steps, regs, seeds, None)
    four = population.train_linear_population_sharded(*args, pmesh.make_mesh(4, device="cpu"))
    single, _, _ = population.train_linear_population(*args)
    for o in two_process:
        got = _arr(o["population"], (worker.POP_MEMBERS, 16))
        np.testing.assert_array_equal(got, four.numpy())
        np.testing.assert_allclose(got, single.numpy(), rtol=0, atol=WEIGHT_TOL)
        apart = int((~np.all(got == single.numpy(), axis=1)).sum())
        print(f"population members not bit-equal to the unsharded engine: {apart} of "
              f"{worker.POP_MEMBERS}, max abs {np.abs(got - single.numpy()).max():.3e}")
