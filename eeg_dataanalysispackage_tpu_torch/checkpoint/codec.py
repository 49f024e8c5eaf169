"""flax's msgpack state-dict bytes for a flat dict of numpy arrays.

The JAX package writes a checkpoint's ``state.msgpack`` with
``flax.serialization.to_bytes`` of the host state dict. For a flat
``{str: ndarray}`` dict that is one msgpack map, its keys in sorted
order (the JAX package maps its state through ``jax.tree_util``, which
rebuilds a dict in sorted key order), each value
``ExtType(1, packb([shape, dtype name, C-order bytes]))``; a 0-d array
is an array like any other. This module writes and reads exactly that
subset, with neither flax nor msgpack installed.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

#: flax's ``_MsgpackExtType.ndarray``
_EXT_NDARRAY = 1


def _uint(n: int) -> bytes:
    if n < 0:
        raise ValueError(f"negative integer {n} in a checkpoint shape")
    if n < 0x80:
        return bytes([n])
    if n <= 0xFF:
        return b"\xcc" + struct.pack(">B", n)
    if n <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", n)
    if n <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", n)
    return b"\xcf" + struct.pack(">Q", n)


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    n = len(raw)
    if n < 32:
        return bytes([0xA0 | n]) + raw
    if n <= 0xFF:
        return b"\xd9" + struct.pack(">B", n) + raw
    if n <= 0xFFFF:
        return b"\xda" + struct.pack(">H", n) + raw
    return b"\xdb" + struct.pack(">I", n) + raw


def _bin(raw: bytes) -> bytes:
    n = len(raw)
    if n <= 0xFF:
        return b"\xc4" + struct.pack(">B", n) + raw
    if n <= 0xFFFF:
        return b"\xc5" + struct.pack(">H", n) + raw
    return b"\xc6" + struct.pack(">I", n) + raw


def _array_header(n: int, fix: int, code16: bytes, code32: bytes) -> bytes:
    if n < 16:
        return bytes([fix | n])
    if n <= 0xFFFF:
        return code16 + struct.pack(">H", n)
    return code32 + struct.pack(">I", n)


def _ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code]) + data
    if n <= 0xFF:
        return b"\xc7" + struct.pack(">B", n) + bytes([code]) + data
    if n <= 0xFFFF:
        return b"\xc8" + struct.pack(">H", n) + bytes([code]) + data
    return b"\xc9" + struct.pack(">I", n) + bytes([code]) + data


def _ndarray(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(
            "Object and structured dtypes not supported for serialization of "
            "ndarrays."
        )
    shape = b"".join(_uint(int(s)) for s in arr.shape)
    payload = (
        bytes([0x93])
        + _array_header(arr.ndim, 0x90, b"\xdc", b"\xdd") + shape
        + _str(arr.dtype.name)
        + _bin(arr.tobytes("C"))
    )
    return _ext(_EXT_NDARRAY, payload)


def to_bytes(state: Dict[str, np.ndarray]) -> bytes:
    """``flax.serialization.to_bytes`` of the JAX package's host copy of
    ``state`` (every value an array, or a scalar made one)."""
    keys = sorted(state)
    out = [_array_header(len(keys), 0x80, b"\xde", b"\xdf")]
    for key in keys:
        if not isinstance(key, str):
            raise ValueError(f"checkpoint keys must be str, got {key!r}")
        out.append(_str(key))
        out.append(_ndarray(np.asarray(state[key])))
    return b"".join(out)


class _Reader:
    """A cursor over the msgpack subset :func:`to_bytes` writes."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated checkpoint payload")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def be(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def container(self, fix: int, code16: int, code32: int, what: str) -> int:
        b = self.byte()
        if b & 0xF0 == fix:
            return b & 0x0F
        if b == code16:
            return self.be(">H")
        if b == code32:
            return self.be(">I")
        raise ValueError(f"expected a msgpack {what}, got byte 0x{b:02x}")

    def uint(self) -> int:
        b = self.byte()
        if b < 0x80:
            return b
        sizes = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
        if b not in sizes:
            raise ValueError(f"expected a msgpack unsigned int, got byte 0x{b:02x}")
        return self.be(sizes[b])

    def raw(self, fixmask: int, fixbase: int, codes: Tuple[int, int, int], what: str) -> bytes:
        b = self.byte()
        if fixmask and b & fixmask == fixbase:
            return self.take(b & ~fixmask & 0xFF)
        for code, fmt in zip(codes, (">B", ">H", ">I")):
            if b == code:
                return self.take(self.be(fmt))
        raise ValueError(f"expected a msgpack {what}, got byte 0x{b:02x}")

    def str(self) -> str:
        return self.raw(0xE0, 0xA0, (0xD9, 0xDA, 0xDB), "str").decode("utf-8")

    def bin(self) -> bytes:
        return self.raw(0, 0, (0xC4, 0xC5, 0xC6), "bin")

    def ext(self) -> Tuple[int, bytes]:
        b = self.byte()
        fixed = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixed:
            n = fixed[b]
        elif b in (0xC7, 0xC8, 0xC9):
            n = self.be({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        else:
            raise ValueError(f"expected a msgpack ext, got byte 0x{b:02x}")
        code = struct.unpack(">b", self.take(1))[0]
        return code, self.take(n)


def _ndarray_from(payload: bytes) -> np.ndarray:
    r = _Reader(payload)
    if r.container(0x90, 0xDC, 0xDD, "array") != 3:
        raise ValueError("an ndarray payload is [shape, dtype, bytes]")
    shape = tuple(r.uint() for _ in range(r.container(0x90, 0xDC, 0xDD, "array")))
    dtype = np.dtype(r.str())
    buffer = r.bin()
    return np.frombuffer(buffer, dtype=dtype).reshape(shape, order="C").copy()


def from_bytes(data: bytes) -> Dict[str, np.ndarray]:
    """The ``{key: ndarray}`` dict of a ``state.msgpack`` (either
    package's)."""
    r = _Reader(data)
    out = {}
    for _ in range(r.container(0x80, 0xDE, 0xDF, "map")):
        key = r.str()
        code, payload = r.ext()
        if code != _EXT_NDARRAY:
            raise ValueError(f"checkpoint entry {key!r} is not an ndarray (ext {code})")
        out[key] = _ndarray_from(payload)
    if r.pos != len(data):
        raise ValueError("trailing bytes after the checkpoint map")
    return out
