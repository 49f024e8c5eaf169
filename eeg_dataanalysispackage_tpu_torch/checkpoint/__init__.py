"""Checkpoint / resume: step-numbered state checkpoints with atomic writes.

Port of the JAX package's ``checkpoint/`` (:class:`CheckpointManager`
and ``run_resumable``, the resumable step driver of the elastic
trainer, ``obs/failure.py``). The directory layout
and the bytes of each file are the JAX package's, so either package
resumes a directory the other wrote: ``state.msgpack`` is written by
this package's own codec (``checkpoint/codec.py``) for the subset of
flax's msgpack state-dict format that a dict of numpy arrays uses.
"""

from .manager import CheckpointManager, run_resumable

__all__ = ["CheckpointManager", "run_resumable"]
