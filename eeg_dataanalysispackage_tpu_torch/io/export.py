"""Epoch CSV and raw-channel text export (reference:
DataTransformation/DataProviderUtils.java, HadoopLoadingTest.java).

Port of the JAX package's ``io/export.py``. ``write_epochs_to_csv``
dumps channel Pz (``epoch[2]``) of every epoch as a comma-separated row
with a trailing comma (DataProviderUtils.java:30-47). Numbers are
formatted as ``Double.toString`` does
(``utils.java_compat.java_double_to_string``), so the output is
byte-equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np

from ..utils.java_compat import java_double_to_string
from . import remote


def write_epochs_to_csv(epochs: np.ndarray, path: str = "Epochs.csv", channel: int = 2) -> None:
    """Write ``epochs[:, channel, :]`` rows as ``v0,v1,...,v749,\\n``."""
    arr = np.asarray(epochs, dtype=np.float64)
    with open(path, "w") as f:
        for row in arr[:, channel, :]:
            f.write("".join(f"{java_double_to_string(v)}," for v in row))
            f.write("\n")


def write_channel_text(channel: np.ndarray, path: str, filesystem=None) -> None:
    """Write one raw channel as text, one sample per line.

    The reference's raw-read smoke path (HadoopLoadingTest.tryRAWEEG,
    HadoopLoadingTest.java:56-119: read a channel, ``saveAsTextFile`` it
    back to storage), written through ``filesystem`` or, without one,
    through the filesystem the path's URI scheme routes to.
    """
    fs = filesystem or remote.filesystem_for(path)
    arr = np.asarray(channel, dtype=np.float64).ravel()
    fs.write_bytes(path, "".join(f"{java_double_to_string(v)}\n" for v in arr).encode("ascii"))


def read_epochs_csv(path: str) -> np.ndarray:
    """Read a ``write_epochs_to_csv`` file back into (n, T) float64
    (rows have a trailing comma)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip().rstrip(",")
            if line:
                rows.append([float(x) for x in line.split(",")])
    return np.array(rows, dtype=np.float64)
