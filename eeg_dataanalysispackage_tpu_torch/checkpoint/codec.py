"""flax's msgpack state-dict bytes for nested dicts of numpy arrays.

The JAX package writes a checkpoint's ``state.msgpack`` and the body of
a neural-network model file with ``flax.serialization.to_bytes``. For a
tree of ``{str: ndarray | dict}`` that is one msgpack map per dict, each
array ``ExtType(1, packb([shape, dtype name, C-order bytes]))``; a 0-d
array is an array like any other. The key order is the dict's own: a
tree that went through ``jax.tree_util`` (a checkpoint's state, a
trained network's parameters) comes back with its keys sorted at every
level (``layer10`` before ``layer2``, ``bias`` before ``kernel``); the
tree ``model.init`` returns, and one ``from_bytes`` restored into it,
keep flax's creation order. :func:`to_bytes` sorts, as for the former;
``keep_order=True`` writes each dict in its own order, as for the
latter. This module writes and reads exactly that subset, with neither
flax nor msgpack installed.
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


def _map(state: dict, keep_order: bool, out: list) -> None:
    keys = list(state) if keep_order else sorted(state)
    out.append(_array_header(len(keys), 0x80, b"\xde", b"\xdf"))
    for key in keys:
        if not isinstance(key, str):
            raise ValueError(f"checkpoint keys must be str, got {key!r}")
        out.append(_str(key))
        value = state[key]
        if isinstance(value, dict):
            _map(value, keep_order, out)
        else:
            out.append(_ndarray(np.asarray(value)))


def to_bytes(state: Dict[str, object], keep_order: bool = False) -> bytes:
    """``flax.serialization.to_bytes`` of the JAX package's host copy of
    ``state``: every value an array (or a scalar made one) or a nested
    dict of them; keys sorted at every level, or each dict in its own
    order with ``keep_order``."""
    out: list = []
    _map(state, keep_order, out)
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


def _read_map(r: _Reader) -> dict:
    out = {}
    for _ in range(r.container(0x80, 0xDE, 0xDF, "map")):
        key = r.str()
        b = r.data[r.pos] if r.pos < len(r.data) else None
        if b is not None and (b & 0xF0 == 0x80 or b in (0xDE, 0xDF)):
            out[key] = _read_map(r)
            continue
        code, payload = r.ext()
        if code != _EXT_NDARRAY:
            raise ValueError(f"checkpoint entry {key!r} is not an ndarray (ext {code})")
        out[key] = _ndarray_from(payload)
    return out


def from_bytes(data: bytes) -> Dict[str, object]:
    """The ``{key: ndarray | dict}`` tree of a ``state.msgpack`` or of a
    model file's body (either package's), in the file's key order."""
    r = _Reader(data)
    out = _read_map(r)
    if r.pos != len(data):
        raise ValueError("trailing bytes after the checkpoint map")
    return out
