"""Step-numbered state checkpointing with atomic writes and resume.

Port of the JAX package's ``checkpoint/manager.py``
(:class:`CheckpointManager`). Layout::

    <directory>/
      step_00000010/
        state.msgpack    flax msgpack state dict (checkpoint/codec.py)
        metadata.json    {"step": 10, "extra": {...}}
      step_00000020/ ...

A step is written into a ``.tmp-<step>`` sibling, each file fsync'd, and
renamed into place, then the directory is fsync'd: a crash mid-write
never corrupts the latest checkpoint, and a finished save survives a
power loss. Overwriting a step displaces the old directory to
``.old-<step>`` first; :meth:`CheckpointManager._recover` repairs a
crash between the two renames. States are dicts of numpy arrays (or
tensors, copied to the host), nested dicts of them too.

:func:`run_resumable` drives a step function over a batch sequence with
a checkpoint every ``save_every`` steps, skipping the steps a previous
incarnation already saved (JAX package: ``checkpoint/manager.py``
``run_resumable``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from . import codec

_STEP_RE = re.compile(r"^step_(\d{8})$")


def _fsync_directory(directory: str) -> bool:
    """fsync a directory, making a completed rename durable
    (best-effort: some filesystems refuse a directory descriptor). False
    on a refusal, which the plan journal counts."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return False
    try:
        os.fsync(fd)
    except OSError:
        return False
    finally:
        os.close(fd)
    return True


def _write_synced(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _to_host(value):
    """A state leaf as a host array (tensors are copied off the device);
    a nested dict leaf by leaf."""
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    return np.asarray(value)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)
        self._recover()

    def _recover(self) -> None:
        """Clean up after a crash mid-save: ``.tmp-*`` directories are
        partial writes and are discarded; an ``.old-<step>`` directory is
        a displaced checkpoint, moved back when the crash hit between the
        two renames of an overwrite (its step is missing), else
        deleted."""
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if name.startswith(".tmp-"):
                shutil.rmtree(path)
            elif name.startswith(".old-"):
                final = os.path.join(self.directory, "step_" + name[5:])
                if os.path.exists(final):
                    shutil.rmtree(path)
                else:
                    os.rename(path, final)

    # -- inventory -----------------------------------------------------

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name, "state.msgpack")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def _resolve_step(self, step: Optional[int]) -> int:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return step

    # -- save / restore ------------------------------------------------

    def save(self, step: int, state: Dict[str, Any], extra: Optional[Dict] = None) -> str:
        """Atomically write ``state`` (a flat dict of arrays) for
        ``step``; returns the step's directory."""
        final = self._step_dir(step)
        tmp = os.path.join(self.directory, f".tmp-{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        try:
            host = {k: _to_host(v) for k, v in state.items()}
            _write_synced(os.path.join(tmp, "state.msgpack"), codec.to_bytes(host))
            _write_synced(
                os.path.join(tmp, "metadata.json"),
                json.dumps({"step": step, "extra": extra or {}}).encode("utf-8"),
            )
            old = os.path.join(self.directory, f".old-{step:08d}")
            if os.path.exists(final):
                # displace rather than delete: _recover() repairs a crash
                # between these renames, so the previous step is never lost
                if os.path.exists(old):
                    shutil.rmtree(old)
                os.rename(final, old)
            os.rename(tmp, final)
            _fsync_directory(self.directory)
            if os.path.exists(old):
                shutil.rmtree(old)
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
        self._enforce_retention()
        return final

    def restore(
        self, template: Dict[str, Any], step: Optional[int] = None
    ) -> Tuple[Dict[str, np.ndarray], Dict]:
        """``(state, metadata)`` for ``step`` (default: the latest).
        ``template`` names the keys to restore; a key the checkpoint
        lacks raises ``ValueError`` (flax's message)."""
        d = self._step_dir(self._resolve_step(step))
        with open(os.path.join(d, "state.msgpack"), "rb") as f:
            stored = codec.from_bytes(f.read())
        missing = set(map(str, template)).difference(stored)
        if missing:
            raise ValueError(
                "The target dict keys and state dict keys do not match, target "
                f"dict contains keys {missing} which are not present in state "
                "dict at path ."
            )
        with open(os.path.join(d, "metadata.json")) as f:
            metadata = json.load(f)
        return {k: stored[str(k)] for k in sorted(template)}, metadata

    def read_metadata(self, step: Optional[int] = None) -> Dict:
        """The ``metadata.json`` payload of ``step`` (default: the
        latest), without reading the state: a caller that needs a shape
        out of ``extra`` to build its restore template reads it here."""
        with open(os.path.join(self._step_dir(self._resolve_step(step)),
                               "metadata.json")) as f:
            return json.load(f)

    def clear(self) -> None:
        """Delete every checkpoint under the directory (the trajectory
        they protected is finished or superseded)."""
        for step in self.all_steps():
            shutil.rmtree(self._step_dir(step))

    def _enforce_retention(self) -> None:
        if self.max_to_keep is None:
            return
        steps = self.all_steps()
        for step in steps[: max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(self._step_dir(step))


def run_resumable(
    manager: CheckpointManager,
    init_state: Callable[[], Any],
    train_step: Callable,
    batches: Iterable,
    save_every: int = 10,
    on_step: Optional[Callable[[int, Any], None]] = None,
):
    """Drive ``train_step(state, *batch) -> (state, loss)`` over
    ``batches`` with a checkpoint every ``save_every`` steps (and one at
    the end); steps already recorded under ``manager`` are skipped, so a
    re-invocation after a crash continues from the latest checkpoint.
    A restored state is the checkpoint's host arrays under
    ``init_state()``'s keys. Returns ``(state, last_step)``."""
    latest = manager.latest_step()
    if latest is None:
        state, start = init_state(), 0
    else:
        state, _ = manager.restore(init_state(), step=latest)
        start = latest
    step = start
    for i, batch in enumerate(batches):
        if i < start:
            continue  # trained by a previous incarnation
        state, loss = train_step(state, *batch)
        step = i + 1
        if on_step is not None:
            on_step(step, loss)
        if step % save_every == 0:
            manager.save(step, state, extra={"loss": float(loss)})
    if step > start and step % save_every != 0:
        manager.save(step, state)
    return state, step
