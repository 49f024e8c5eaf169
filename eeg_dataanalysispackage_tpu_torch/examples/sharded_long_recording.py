"""Long-recording pipeline: time-sharded marker ingest + raw training.

Usage::

    python -m eeg_dataanalysispackage_tpu_torch.examples.sharded_long_recording \\
        [--device cpu] [--shards N]

``--shards`` defaults to ``min(8, torch.cuda.device_count())`` on the
card and to 8 logical CPU shards with ``--device cpu``; a mesh the
machine cannot build raises (``parallel/mesh.make_mesh``). A synthetic
recording of ``shards x 65,536`` samples goes end to end:

1. the recording is staged time-sharded across the mesh as raw int16
   (half the float32 bytes; the kernel scales on the device);
2. the host plans marker validity and the reference's order-dependent
   class-balance scan, and assigns each kept epoch to the shard owning
   its window start (``parallel/sharded_ingest.py``);
3. every shard's windows are cut and featurized by one launch of the
   fused ingest kernel K1 on its device; windows straddling a shard
   boundary read their tail from a 1,024-sample halo copied from the
   right neighbour;
4. the resulting features train the logreg model (``models/sgd``), and
   for the steady-state (fixed-SOA) segment the raw-stream train step
   (``parallel/train.make_raw_train_step``, K1 again) updates the MLP
   straight from int16 samples.
"""

import sys

import numpy as np
import torch

from . import k1_launches, kernel_line, parser

RESOLUTIONS = np.array([0.1, 0.1, 0.2], np.float32)


def default_shards(device) -> int:
    """8 logical shards on the CPU; on the card one a card, at most 8."""
    return 8 if torch.device(device).type == "cpu" else min(8, torch.cuda.device_count())


def run(device=None, shards=None, block: int = 65536, sgd_iterations: int = 50,
        steps: int = 3, key=0, mesh_devices=None) -> dict:
    """The four steps on one seeded recording; returns the sharded rows
    (on the mesh's first device), the plan, the markers and the stream,
    the logreg weights and train accuracy, the raw-stream losses and K1's
    launches. ``mesh_devices``: an explicit device list for the time axis
    (it may repeat a device, ``parallel/mesh.make_mesh(devices=)``)
    instead of ``shards`` devices of ``device``'s kind. ``key``: the
    MLP's ``init_state`` key (a seed, or a mapping of carried-over
    weights)."""
    from ..io.brainvision import Marker
    from ..models import sgd
    from ..parallel import mesh as pmesh, sharded_ingest, train as ptrain
    from ..utils.device import host_to_device, resolve_device

    dev = resolve_device(device)
    if mesh_devices is not None:
        tmesh = pmesh.make_mesh(axes=(pmesh.TIME_AXIS,), devices=mesh_devices)
    else:
        tmesh = pmesh.make_mesh(shards or default_shards(dev), axes=(pmesh.TIME_AXIS,),
                                device=dev)
    n_dev = len(tmesh.axis_devices(pmesh.TIME_AXIS))
    first_dev = tmesh.first_device
    rng = np.random.RandomState(0)

    # -- synthetic recording: n_dev x 64k samples (~65 s a shard at 1 kHz)
    T = n_dev * block
    dc = np.array([[1500], [-900], [400]], np.int16)
    raw = (rng.randint(-3000, 3000, size=(3, T)) + dc).astype(np.int16)
    res = RESOLUTIONS

    # stimulus markers every ~800 samples with jitter; digits 1..9
    base = np.arange(200, T - 1000, 800)
    positions = base + rng.randint(-150, 150, size=base.shape)
    markers = [Marker(f"Mk{i}", "Stimulus", f"S  {1 + i % 9}", int(p))
               for i, p in enumerate(positions)]

    before = k1_launches()
    # -- 1-3: plan on the host, ingest across the mesh
    plan = sharded_ingest.plan_sharded_ingest(markers, guessed_number=4, n_samples=T,
                                              n_shards=n_dev, block=block)
    extract = sharded_ingest.make_sharded_ingest(tmesh)
    staged = sharded_ingest.stage_recording_int16(raw, tmesh)
    feats = extract(staged, res, plan)

    # -- 4a: classify the sharded-ingest features
    targets = torch.as_tensor(plan.targets.astype(np.float32), device=feats.device)
    w = sgd.train_linear(feats.to(torch.float32), targets,
                         sgd.SGDConfig(num_iterations=sgd_iterations))
    margin = feats.to(torch.float32) @ w
    acc = float(((margin > 0) == (targets > 0.5)).to(torch.float64).mean())

    # -- 4b: steady-state segment -> raw-stream training
    stride, first = 800, 200
    n_ep = min(512, (T - first - 8192) // stride)
    init_state, step = ptrain.make_raw_train_step(stride, n_ep, device=first_dev)
    state = init_state(key)
    labels = (rng.rand(n_ep) > 0.5).astype(np.float32)
    raw_t = host_to_device(raw, first_dev)
    mask = np.ones((n_ep,), np.float32)
    losses = []
    for _ in range(steps):
        state, loss = step(state, raw_t, res, labels, mask, first)
        losses.append(float(loss))
    return {"device": str(first_dev), "shards": n_dev, "raw": raw, "resolutions": res,
            "markers": markers, "plan": plan, "features": feats, "weights": w,
            "train_accuracy": acc, "halo_windows": plan.halo_windows(787), "losses": losses,
            "k1_launches": k1_launches() - before}


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--shards", type=int, default=None,
                    help="time shards (default: min(8, cards); 8 with --device cpu)")
    ap.add_argument("--block", type=int, default=65536, help="samples a shard (default 65536)")
    args = ap.parse_args(argv)
    out = run(args.device, args.shards, args.block)
    feats = out["features"]
    print(f"{len(out['markers'])} markers -> {feats.shape[0]} balanced epochs "
          f"featurized across {out['shards']} time shards: {tuple(feats.shape)}")
    print(f"logreg on sharded-ingest features: train accuracy {out['train_accuracy']:.2f}")
    for i, loss in enumerate(out["losses"]):
        print(f"raw-stream train step {i}: loss {loss:.4f}")
    print(kernel_line(out["k1_launches"], out["device"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
