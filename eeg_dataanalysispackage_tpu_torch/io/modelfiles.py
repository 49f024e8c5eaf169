"""Model file bytes, routed through the pluggable filesystem.

Port of the JAX package's ``io/modelfiles.py``. The reference's
classifiers save and load models on the cluster filesystem
(``model.save(sc, path)`` onto HDFS —
LogisticRegressionClassifier.java:144-152). Every classifier serializes
to bytes and hands them here, so ``save_name=`` and ``load_name=`` work
for local paths (``file://`` tolerated) and remote URIs (``http(s)://``,
``gs://``, ``hdfs://`` — ``io/remote.py``) alike. Local model files and
report files are written atomically (:func:`atomic_write_bytes`).
"""

from __future__ import annotations

import os
import shutil

from . import remote, sources


def _fs_for(path: str):
    """The filesystem that serves ``path`` (``io/remote.filesystem_for``,
    the one scheme dispatch)."""
    return remote.filesystem_for(path)


def _is_local(path: str) -> bool:
    return isinstance(_fs_for(path), sources.LocalFileSystem)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Crash-safe local small-file write: tmp sibling, fsync,
    ``os.replace``; missing parent directories are made.

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
    """A stale directory at a local save target is deleted first
    (LogisticRegressionClassifier.java:144-147); a no-op for remote URIs
    and non-directories."""
    if not _is_local(path):
        return
    local = sources.LocalFileSystem._strip(path)
    if os.path.isdir(local):
        shutil.rmtree(local)


def write_model_bytes(path: str, data: bytes) -> None:
    """Write serialized model bytes to a local path (atomically, parent
    directories made) or a remote URI."""
    fs = _fs_for(path)
    if isinstance(fs, sources.LocalFileSystem):
        atomic_write_bytes(fs._strip(path), data)
    else:
        fs.write_bytes(path, data)


def read_model_bytes(path: str) -> bytes:
    """Read serialized model bytes from a local path or remote URI;
    ``FileNotFoundError`` for a missing file on either (the remote layer
    maps 404 onto it)."""
    return _fs_for(path).read_bytes(path)
