"""The filesystem protocol and ``info.txt`` parsing.

Port of the JAX package's ``io/sources.py``. The reference hard-codes
one HDFS endpoint (``Const.java:38-39``, ``OffLineDataProvider.java:90``);
here every read and write goes through a small filesystem protocol:
local POSIX by default, the remote filesystems of ``io/remote.py`` by
URI scheme. The ``info.txt`` format and its quirks are the reference's
(``OffLineDataProvider.loadFilesFromInfoTxt``, :283-319):

- blank lines and lines starting with ``#`` are skipped,
- each line is ``<path-to-.eeg> <guessed number> [ignored extras]``,
- single-field lines are silently ignored,
- a bad number raises,
- duplicate paths collapse, last guess wins, first-seen order kept
  (the reference stores into a ``LinkedHashMap`` — :53).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Protocol


class FileSystem(Protocol):
    def exists(self, path: str) -> bool: ...

    def read_bytes(self, path: str) -> bytes: ...

    def read_text(self, path: str) -> str: ...

    def write_bytes(self, path: str, data: bytes) -> None: ...


class LocalFileSystem:
    """POSIX filesystem (``file://`` URIs tolerated, like the
    reference's path handling)."""

    @staticmethod
    def _strip(path: str) -> str:
        return path[len("file://"):] if path.startswith("file://") else path

    def exists(self, path: str) -> bool:
        return os.path.exists(self._strip(path))

    def size(self, path: str) -> int:
        """Byte length by stat, without reading the file."""
        return os.path.getsize(self._strip(path))

    def read_bytes(self, path: str) -> bytes:
        with open(self._strip(path), "rb") as f:
            return f.read()

    def read_text(self, path: str) -> str:
        with open(self._strip(path), "r", encoding="utf-8", errors="replace") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes) -> None:
        with open(self._strip(path), "wb") as f:
            f.write(data)


class InMemoryFileSystem:
    """Dict-backed filesystem for hermetic tests."""

    def __init__(self, files: Optional[Dict[str, bytes]] = None):
        self.files: Dict[str, bytes] = dict(files or {})

    def exists(self, path: str) -> bool:
        return path in self.files

    def size(self, path: str) -> int:
        return len(self.files[path])

    def read_bytes(self, path: str) -> bytes:
        return self.files[path]

    def read_text(self, path: str) -> str:
        return self.files[path].decode("utf-8", errors="replace")

    def write_bytes(self, path: str, data: bytes) -> None:
        self.files[path] = data


def parse_info_txt(text: str) -> Dict[str, int]:
    """``info.txt`` -> ordered {relative .eeg path: guessed number}."""
    files: Dict[str, int] = {}
    for line in text.splitlines():
        if len(line) == 0 or line[0] == "#":
            continue
        # Java's String.split(" ") discards trailing empty strings, so
        # 'path ' (trailing space) parses as a single-field line and is
        # silently skipped (OffLineDataProvider.java:302-305).
        parts = line.split(" ")
        while parts and parts[-1] == "":
            parts.pop()
        if len(parts) > 1:
            try:
                num = int(parts[1])
            except ValueError as e:
                raise ValueError(
                    f"Line {line!r} contains an improper number format"
                ) from e
            files[parts[0]] = num
    return files
