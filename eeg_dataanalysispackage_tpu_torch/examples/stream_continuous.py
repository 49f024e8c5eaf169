"""Continuous-EEG streaming feature extraction, two ways.

Usage::

    python -m eeg_dataanalysispackage_tpu_torch.examples.stream_continuous \\
        [--device cpu] [--shards N]

Generates a synthetic 64-channel continuous recording and extracts
band-passed DWT features per 512-sample window (stride 256); each window
is one ``torch.matmul`` with the band-passed cascade matrix (no kernel of
this path is written by hand: the reference's streaming path is a plain
contraction too):

1. bounded-memory blocked streaming on one device
   (``parallel/streaming.blocked_features``): recordings of any length,
   O(block) device memory, int16 shipped raw and scaled on the device;
2. mesh-sharded (sequence-parallel) extraction
   (``make_streaming_extractor`` over ``stage_recording``): the time axis
   split over ``--shards`` devices (default: every card, at most 8; 8
   logical CPU shards with ``--device cpu``), each shard reading a halo
   copied from its right neighbour.
"""

import sys

import numpy as np

from . import parser


def run(device=None, channels: int = 64, samples: int = 1 << 17, block: int = 16384,
        shards=None, mesh_devices=None) -> dict:
    """Both extractors on one seeded recording; returns the blocked rows
    (numpy), the mesh rows (on the mesh's first device, or None when the
    recording does not split over the shards) and the shard count.
    ``mesh_devices``: an explicit device list for the time axis, as in
    ``parallel/mesh.make_mesh(devices=)``."""
    from ..parallel import mesh as pmesh, streaming
    from ..utils.device import resolve_device
    from .sharded_long_recording import default_shards

    dev = resolve_device(device)
    C, T = channels, samples  # the defaults: ~2 minutes of 64 ch at 1 kHz
    rng = np.random.RandomState(0)
    raw = rng.randint(-3000, 3000, size=(C, T)).astype(np.int16)
    res = np.full(C, 0.1, np.float32)

    blocked = streaming.blocked_features(raw, block=block, resolutions=res, device=dev)

    n_dev = len(mesh_devices) if mesh_devices is not None else (shards or default_shards(dev))
    sharded = None
    if T % n_dev == 0:
        if mesh_devices is not None:
            mesh = pmesh.make_mesh(axes=(pmesh.TIME_AXIS,), devices=mesh_devices)
        else:
            mesh = pmesh.make_mesh(n_dev, axes=(pmesh.TIME_AXIS,), device=dev)
        extract = streaming.make_streaming_extractor(mesh, window=512, stride=256)
        signal = raw.astype(np.float32) * res[:, None]
        sharded = extract(streaming.stage_recording(signal, mesh))
    return {"device": str(dev), "channels": C, "samples": T, "blocked": blocked,
            "mesh": sharded, "shards": n_dev}


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--samples", type=int, default=1 << 17)
    ap.add_argument("--shards", type=int, default=None,
                    help="time shards (default: min(8, cards); 8 with --device cpu)")
    args = ap.parse_args(argv)
    out = run(args.device, args.channels, args.samples, shards=args.shards)
    print(f"blocked streaming: {out['blocked'].shape} features from "
          f"{out['channels']}ch x {out['samples']} samples")
    if out["mesh"] is not None:
        wrapped = out["mesh"].shape[0] - out["blocked"].shape[0]
        print(f"mesh streaming over {out['shards']} device(s): {tuple(out['mesh'].shape)} "
              f"(the last {wrapped} row(s) wrap the ring)")
    print("no hand-written kernel on this path: one torch.matmul a window block "
          f"on {out['device']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
