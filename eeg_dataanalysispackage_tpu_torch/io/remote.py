"""Remote locations, which the port does not read yet.

The JAX package opens ``info_file=``, ``.eeg`` arguments and model files
on a filesystem chosen by the location's URI scheme (its
``io/remote.filesystem_for``: ``http(s)://``, ``gs://``, ``hdfs://``).
The port reads local paths only. A location with a URI scheme raises
here, before anything is opened, so no connection is attempted.
"""

from __future__ import annotations

import re

_URI_SCHEME = re.compile(r"([A-Za-z][A-Za-z0-9+.-]*)://")


def refuse_remote(location, what: str) -> None:
    """Raise ``ValueError`` if ``location`` carries a URI scheme
    (``scheme://...``); ``what`` names the location in the message."""
    match = _URI_SCHEME.match(str(location))
    if match:
        raise ValueError(
            f"{what} {location!r}: remote locations ({match.group(1)}://) are "
            "not yet ported; see ROADMAP.md"
        )
