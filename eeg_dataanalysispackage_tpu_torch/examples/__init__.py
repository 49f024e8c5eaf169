"""The library API, walked through: the port's twins of the JAX
package's ``examples/`` scripts.

Each is a module with ``run(device=None, ...) -> dict`` (the numbers its
lines print) and ``main(argv=None)`` (the lines), and runs as
``python -m eeg_dataanalysispackage_tpu_torch.examples.<name>``;
importing one runs nothing. ``device=None`` (and no ``--device``) is the
CUDA card, through ``utils/device.resolve_device``: without a card it
raises, and nothing falls back to the CPU; ``--device cpu`` asks for the
CPU, where every kernel wrapper runs its plain PyTorch version. Default
sizes and the numpy ``RandomState`` seeds are the JAX scripts' own.

- :mod:`.train_p300`: a query through ``PipelineBuilder``, then
  ``load_features_device`` (K1) and a logreg fit;
- :mod:`.fused_ingest`: K1's plain PyTorch version, K1, and the
  regular-train featurizer (K1 at ``first + k * stride``);
- :mod:`.raw_stream_training`: the raw-stream train steps (K1), a crash
  and a resume bit-identical to an uninterrupted run;
- :mod:`.sharded_long_recording`: the time-sharded ingest (K1 once a
  shard), SGD on its rows, the raw-stream step;
- :mod:`.stream_continuous`: the blocked and the mesh streaming
  extractors (no kernel: one ``torch.matmul`` a block);
- :mod:`.mllib_migration`: an MLlib GLM directory imported, a random
  forest exported and read back (no kernel).
"""

import argparse


def k1_launches() -> int:
    """The fused ingest kernel's (K1, ``csrc/ingest_features.cu``) launch
    count so far; a walkthrough reports its own delta."""
    from ..ops import ingest_cuda

    return ingest_cuda.LAUNCHES


def kernel_line(launches: int, device) -> str:
    """Which of K1 and its plain version ran, from the launch delta."""
    if launches:
        return f"K1 (csrc/ingest_features.cu): {launches} launch(es) on {device}"
    return f"K1's plain PyTorch version on {device} (no kernel launch)"


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with ``--device`` (default: the CUDA card)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the CUDA card; raises without one)")
    return ap
