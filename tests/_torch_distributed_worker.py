"""One rank of the port's two-process collectives check.

Run by tests/test_torch_distributed.py (and, on the card, by
chip_smoke.py's phase 4j) as its own process:

    python _torch_distributed_worker.py <params.npz> <device>

with ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID`` in the environment: the twin of the JAX package's
``tests/_distributed_worker.py`` over ``torch.distributed``. It runs
``distributed.initialize`` (env-driven) -> ``hybrid_mesh`` (hosts x 2
local devices: two logical CPU shards, or the rank's card twice) ->
``stage_global_batch`` -> the cross-process sums; the flagship train step
over the hosts x data mesh from the MLP parameters in ``params.npz``;
the streaming extractor over a 4-shard time axis whose halo crosses the
process boundary; the sharded marker ingest likewise; data-parallel SGD
(full batch and mini-batch); and the member-sharded population. It prints
one JSON line; arrays are float32 bytes in hex, so the parent holds them
bit for bit. Imports neither JAX nor the JAX package.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from eeg_dataanalysispackage_tpu_torch.io.brainvision import Marker  # noqa: E402
from eeg_dataanalysispackage_tpu_torch.models import sgd  # noqa: E402
from eeg_dataanalysispackage_tpu_torch.ops import ingest_cuda  # noqa: E402
from eeg_dataanalysispackage_tpu_torch.parallel import (  # noqa: E402
    distributed, mesh as pmesh, population, sharded_ingest, streaming, train as ptrain,
)


def hexed(t) -> str:
    return np.ascontiguousarray(
        (t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)).astype(np.float32)
    ).tobytes().hex()


def cases():
    """The global inputs every rank (and the parent's one-process runs)
    make from the same seeds."""
    rng = np.random.RandomState(0)
    epochs = rng.randn(4, 3, 750).astype(np.float32)
    labels = (rng.rand(4) > 0.5).astype(np.float32)
    signal = np.random.RandomState(1).randn(2, 2048).astype(np.float32) * 30.0
    T = 4 * 2048
    raw = (np.random.RandomState(2).randn(3, T) * 200).astype(np.int16)
    block = T // 4
    positions = [500, block - 30, 2 * block - 5, 3 * block + 40]
    markers = [Marker(f"Mk{i}", "Stimulus", f"S  {1 + i % 9}", p)
               for i, p in enumerate(positions)]
    rng = np.random.RandomState(3)
    x = rng.randn(203, 16).astype(np.float32)
    y = (x @ rng.randn(16) > 0).astype(np.float32)
    return epochs, labels, signal, raw, markers, x, y


POP_MEMBERS = 16
SGD_CONFIGS = {"full": dict(num_iterations=40),
               "minibatch": dict(num_iterations=30, mini_batch_fraction=0.5)}


def population_args(p=POP_MEMBERS):
    return ([1.0 / (1 + i % 4) for i in range(p)], [0.0, 0.01] * (p // 2), list(range(p)))


def main() -> None:
    params_path, device = sys.argv[1], sys.argv[2]
    distributed.initialize(device=device)  # env-driven bootstrap
    pid, n = distributed.process_index(), distributed.process_count()
    dev = torch.device(device)
    # two local shards: logical CPU shards, or the rank's card twice
    mesh = distributed.hybrid_mesh(devices=[dev, dev])
    epochs, labels, signal, raw, markers, x, y = cases()

    # each process stages only its own shard of the global batch
    local = np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * pid
    batch = distributed.stage_global_batch(local, mesh)
    total = float(batch.sum())
    params = distributed.replicate_across_hosts({"w": np.full(3, 2.0, np.float32)}, mesh)
    # d/dw sum(x @ w) = the global column sums: every shard's, in order
    grad = pmesh.sum_in_order([s.sum(dim=0) for s in batch.shards], mesh.first_device,
                              across_processes=True)

    # the flagship train step over the hosts x data mesh
    init_state, train_step = ptrain.make_train_step(mesh)
    with np.load(params_path) as f:
        state = init_state({k: f[k] for k in f.files})
    ep = distributed.stage_global_batch(epochs[2 * pid: 2 * pid + 2], mesh)
    lb = distributed.stage_global_batch(labels[2 * pid: 2 * pid + 2], mesh)
    mk = distributed.stage_global_batch(np.ones(2, np.float32), mesh)
    state, loss = train_step(state, ep, lb, mk)

    # sequence-parallel streaming: the halo crosses the process boundary
    tmesh = distributed.hybrid_mesh(ici_axes=("time",), devices=[dev, dev])
    extract = streaming.make_streaming_extractor(tmesh, window=512, stride=256)
    feats = extract(streaming.stage_recording_local(
        signal[:, 1024 * pid: 1024 * (pid + 1)], tmesh))

    # sequence-parallel marker ingest: windows straddling the process
    # boundary read their tail from the next process
    T = raw.shape[1]
    block = T // 4
    res = np.full(3, 0.1, np.float32)
    plan = sharded_ingest.plan_sharded_ingest(markers, 2, T, 4, block)
    ingest = sharded_ingest.make_sharded_ingest(tmesh)
    rows = ingest(sharded_ingest.stage_recording_local_int16(
        raw[:, 2 * block * pid: 2 * block * (pid + 1)], tmesh), res, plan)

    # data-parallel SGD over hosts x data, full batch and mini-batch
    weights = {name: sgd.train_linear(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
                                      sgd.SGDConfig(**cfg), mesh=mesh)
               for name, cfg in SGD_CONFIGS.items()}

    # the member axis over hosts x data
    steps, regs, seeds = population_args()
    pop = population.train_linear_population_sharded(
        torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
        sgd.SGDConfig(num_iterations=200, convergence_tol=0.0), steps, regs, seeds, None, mesh,
        axis=("hosts", "data"))

    print(json.dumps({
        "pid": pid,
        "k1": ingest_cuda.LAUNCHES,
        "procs": n,
        "backend": distributed.backend(),
        "devices": int(mesh.devices.size),
        "mesh": mesh.shape,
        "time_mesh": tmesh.shape,
        "total": total,
        "wsum": float(params["w"].sum()),
        "grad": grad.tolist(),
        "loss": hexed(loss.reshape(1)),
        "params": {k: hexed(v) for k, v in state["params"].items()},
        "stream": hexed(feats),
        "stream_shape": list(feats.shape),
        "ingest": hexed(rows),
        "ingest_rows": int(rows.shape[0]),
        "sgd": {k: hexed(w) for k, w in weights.items()},
        "population": hexed(pop),
    }))


if __name__ == "__main__":
    main()
