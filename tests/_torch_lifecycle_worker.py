"""The port's kill-mid-partial-fit worker for the lifecycle resume pin.

Run by tests/test_torch_lifecycle.py as its own process:

    python _torch_lifecycle_worker.py <ckpt_dir> <n_batches> [<kill_after>]

Feeds a deterministic labeled feedback stream (:func:`feedback_stream`,
the JAX package's worker's stream) through the port's
``LifecycleManager`` on the CPU, whose featurizer is the identity over
ready-made feature rows: no engine and no model, only the partial-fit
and checkpoint machinery. After each flushed batch it prints
``CKPT <batches>``. Given ``kill_after``, it stops after that many
batches' checkpoints and blocks on a line from stdin that never comes,
so the test's SIGKILL lands at a fixed point; the test then runs it again over
the same directory (the manager restores the latest checkpoint and
:func:`run` resumes from ``batches_trained``) and compares the final
candidate weights byte for byte with an uninterrupted twin. Imports
neither JAX nor the JAX package.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

D = 48
BATCH = 8


def feedback_stream(n_batches: int, d: int = D, batch: int = BATCH):
    """The one stream: batch b is a pure function of (7, b)."""
    rng = np.random.RandomState(7)
    out = []
    for _ in range(n_batches):
        rows = rng.randn(batch, d).astype(np.float32)
        labels = (rng.rand(batch) > 0.5).astype(np.float64)
        out.append((rows, labels))
    return out


def make_lifecycle(ckpt_dir: str):
    from eeg_dataanalysispackage_tpu_torch.serve.lifecycle import (
        LifecycleConfig,
        LifecycleManager,
    )

    config = LifecycleConfig(
        adapt_batch=BATCH, adapt_iters=5, capacity=64, drift_window=16,
        gate_mode="off", gate_ratio=None, checkpoint_dir=ckpt_dir,
    )
    return LifecycleManager(
        None, config, device="cpu",
        featurize=lambda windows, _res: np.stack([np.asarray(w, np.float32) for w in windows]),
    )


def run(ckpt_dir: str, n_batches: int, kill_after=None):
    """Feed batches ``batches_trained .. n_batches`` (resume-aware), one
    flush a batch, printing a CKPT line after each; with ``kill_after``,
    wait for the kill after that many checkpoints instead of going on."""
    lc = make_lifecycle(ckpt_dir)
    stream = feedback_stream(n_batches)
    res = np.ones(3, np.float32)
    lc.start()
    for b in range(lc.batches_trained, n_batches):
        rows, labels = stream[b]
        for i in range(len(rows)):
            lc.feedback(rows[i], res, float(labels[i]))
        assert lc.flush(timeout_s=60.0), "adapter did not go idle"
        print(f"CKPT {lc.batches_trained}", flush=True)
        if kill_after is not None and lc.batches_trained >= kill_after:
            sys.stdin.readline()  # the parent kills this process here
            raise SystemExit("stdin closed before the kill")
    lc.close(flush=True)
    return lc


if __name__ == "__main__":
    manager = run(sys.argv[1], int(sys.argv[2]),
                  int(sys.argv[3]) if len(sys.argv) > 3 else None)
    w = manager.candidate.w if manager.candidate is not None else None
    print("W " + (w.astype(np.float32).tobytes().hex() if w is not None else "none"),
          flush=True)
