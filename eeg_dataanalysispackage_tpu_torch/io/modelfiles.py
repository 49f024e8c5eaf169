"""Local file helpers for model archives and report files."""

from __future__ import annotations

import os
import shutil


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Crash-safe small-file write: tmp sibling, fsync, ``os.replace``.

    A crash mid-write leaves the previous content (or nothing), never a
    truncated file.
    """
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp-{os.getpid()}-{os.path.basename(path)}")
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def delete_local_dir_target(path: str) -> None:
    """A stale directory at a save target is deleted first
    (LogisticRegressionClassifier.java:144-147)."""
    if os.path.isdir(path):
        shutil.rmtree(path)


def read_model_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()
