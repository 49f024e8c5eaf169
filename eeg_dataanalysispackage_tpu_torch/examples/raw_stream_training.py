"""Training straight from the int16 stream, with crash recovery.

Usage::

    python -m eeg_dataanalysispackage_tpu_torch.examples.raw_stream_training [--device cpu]

The reference trains on host-materialized epochs (per-marker window
copies, then Spark RDDs of float[][]). Here one step runs ingest -> DWT
features -> MLP forward/backward -> optimizer update from the RAW int16
stream, with no host epochs: the fused ingest kernel K1 cuts and
featurizes the windows on the device, autograd and the nesterov SGD
update run on its rows. Three steps of the family, plus the recovery
story:

1. regular stimulus train (``parallel/train.make_raw_train_step``): a
   fixed stimulus-onset asynchrony, K1 at ``first + k * stride``;
2. irregular markers (``make_irregular_train_step``): K1 at an ingest
   plan's padded positions, the padded rows masked out of the loss;
3. crash + resume through ``checkpoint.CheckpointManager`` and
   ``run_resumable``: re-running after a simulated crash lands
   bit-identical to the uninterrupted run.
"""

import sys
import tempfile

import numpy as np
import torch

from . import k1_launches, kernel_line, parser

RESOLUTIONS = np.array([0.1, 0.1, 0.2], np.float32)


def run(device=None, n: int = 512, stride: int = 800, first: int = 150, cap: int = 512,
        steps: int = 3, batches: int = 6, crash_at: int = 4, save_every: int = 2,
        keys=(0, 1, 2)) -> dict:
    """The three parts on one seeded stream; returns the losses, the
    checkpoints left by the crash, the resumed and the uninterrupted
    parameters (host arrays) and K1's launches. ``keys``: the initial
    state of part 1, 2 and 3, each an ``init_state`` key (a seed for the
    port's threefry draws, or a mapping of carried-over weights)."""
    from ..checkpoint import CheckpointManager, run_resumable
    from ..parallel import train as ptrain
    from ..utils.device import host_to_device, resolve_device

    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    res = RESOLUTIONS
    before = k1_launches()

    # --- 1. regular stimulus train
    S = 200 + n * stride + 8192
    raw = rng.randint(-3000, 3000, size=(3, S), dtype=np.int16)
    raw_t = host_to_device(raw, dev)
    labels = (rng.rand(n) > 0.5).astype(np.float32)
    init_state, step = ptrain.make_raw_train_step(stride, n, device=dev)
    state = init_state(keys[0])
    mask = np.ones((n,), np.float32)
    regular = []
    for _ in range(steps):
        state, loss = step(state, raw_t, res, labels, mask, first)
        regular.append(float(loss))

    # --- 2. irregular markers
    positions = np.sort(
        rng.choice(np.arange(200, S - 900), size=cap, replace=False)
    ).astype(np.int32)
    mask_irr = np.ones(cap, bool)
    labels_irr = (rng.rand(cap) > 0.5).astype(np.float32)
    init_irr, irr_step = ptrain.make_irregular_train_step(device=dev)
    state_irr = init_irr(keys[1])
    irregular = []
    for _ in range(steps):
        state_irr, loss = irr_step(state_irr, raw_t, res, positions, mask_irr, labels_irr)
        irregular.append(float(loss))

    # --- 3. crash + resume
    def stream():
        for k in range(batches):
            r = np.random.RandomState(100 + k)
            pos = np.sort(
                r.choice(np.arange(200, S - 900), size=cap, replace=False)
            ).astype(np.int32)
            yield raw_t, res, pos, mask_irr, (r.rand(cap) > 0.5).astype(np.float32)

    def crashing(stop):
        for i, b in enumerate(stream()):
            if i == stop:
                raise RuntimeError("simulated crash")
            yield b

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        crashed = False
        try:
            run_resumable(mgr, lambda: init_irr(keys[2]), irr_step, crashing(crash_at),
                          save_every=save_every)
        except RuntimeError:
            crashed = True
        crashed_checkpoints = mgr.all_steps()
        state_resumed, resumed_at = run_resumable(mgr, lambda: init_irr(keys[2]), irr_step,
                                                  stream(), save_every=save_every)
    # the uninterrupted reference run for the bit-identity claim
    with tempfile.TemporaryDirectory() as d:
        ref_state, _ = run_resumable(CheckpointManager(d), lambda: init_irr(keys[2]),
                                     irr_step, stream(), save_every=save_every)
    resumed = {k: torch.as_tensor(v).cpu().numpy() for k, v in state_resumed["params"].items()}
    reference = {k: torch.as_tensor(v).cpu().numpy() for k, v in ref_state["params"].items()}
    same = all(np.array_equal(resumed[k], reference[k]) for k in reference)
    return {"device": str(dev), "formulation": step.formulation,
            "regular_losses": regular, "irregular_losses": irregular,
            "crashed": crashed, "crash_at": crash_at,
            "crashed_checkpoints": crashed_checkpoints,
            "resumed_at": resumed_at, "resumed_params": resumed,
            "reference_params": reference, "bit_identical": same,
            "k1_launches": k1_launches() - before}


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--n", type=int, default=512, help="regular-train epochs (default 512)")
    ap.add_argument("--cap", type=int, default=512, help="irregular markers (default 512)")
    args = ap.parse_args(argv)
    out = run(args.device, n=args.n, cap=args.cap)
    for i, loss in enumerate(out["regular_losses"]):
        print(f"regular raw-stream step {i}: loss {loss:.4f}")
    for i, loss in enumerate(out["irregular_losses"]):
        print(f"irregular raw-stream step {i}: loss {loss:.4f}")
    if out["crashed"]:
        print(f"crashed at step {out['crash_at']}; checkpoints: {out['crashed_checkpoints']}")
    print(f"resumed and finished at step {out['resumed_at']}")
    print(f"resumed == uninterrupted (bit-identical params): {out['bit_identical']}")
    print(kernel_line(out["k1_launches"], out["device"]))
    if not out["bit_identical"]:
        raise AssertionError("the resumed run's parameters differ from the uninterrupted run's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
